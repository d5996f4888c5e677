/* colcore — C fast path for the columnar data plane.
 *
 * Round-4 answer to VERDICT.md item #1 (kill the ~2.3 us/event Python
 * floor).  Design rule: this module accelerates FUNCTIONS, never forks
 * data STRUCTURES.  Egress rows stay the same 12-field Python tuples
 * Host.emit_msg appends; store rows stay the same 13-field tuples in the
 * same StoreBatch/pending deque; the event heap stays EventQueue._heap.
 * Every Python path (mesh plane, fault filters, pcap hosts, managed
 * bridges, round_robin qdisc) therefore interoperates with the C path
 * per-phase with no conversion layer, and the bit-identity obligations
 * (tests/test_colplane.py, test_colcore.py) reduce to "same arithmetic,
 * same order" — which this file replicates operation-for-operation from
 * network/colplane.py, network/fluid.py and host/host.py.
 *
 * What runs in C:
 *   - Core.barrier():   egress collection, uid minting, blackhole filter,
 *                       closed-form token-bucket departures (the exact
 *                       integer math of fluid.TokenBuckets), latency and
 *                       loss-threshold gathers, inline threefry loss
 *                       draws, and sorted store construction.  Batches
 *                       big enough for the device draw plane are handed
 *                       back to Python (the existing dispatch machinery).
 *   - Core.extract():   due-prefix extraction from the pending store into
 *                       per-host C inboxes (per-host (t,key) order).
 *   - Core.run_round(): the per-round host loop: inbox/heap merge, C heap
 *                       pops, ingress-bucket charging, datagram dispatch,
 *                       and the C gossip app; Python callables (timers,
 *                       stream endpoints, plugin callbacks) are invoked
 *                       through the normal C API when a row or event
 *                       isn't C-handled.
 *   - GossipState:      the gossip model's hot half (models/gossip.py
 *                       delegates; peer selection/logging stay Python).
 *
 * Reference analog (SURVEY.md): upstream Shadow's hot path is native
 * (Rust/C) for exactly this reason; the Python plane remains as the
 * readable twin and the oracle for the dual-run tests.
 */
#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <marshal.h>
#define NPY_NO_DEPRECATED_API NPY_1_7_API_VERSION
#include <numpy/arrayobject.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>

/* Python < 3.12 spells the member API via structmember.h (T_INT/READONLY);
 * 3.12 moved the canonical names into Python.h. Compile against both. */
#ifndef Py_T_INT
#include <structmember.h>
#define Py_T_INT T_INT
#define Py_READONLY READONLY
#endif

static int64_t tm_sect[12];
static int64_t tm_cnt[12];
#ifdef COLCORE_TIMERS
#include <time.h>
static inline int64_t nsnow(void) {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return ts.tv_sec * 1000000000LL + ts.tv_nsec;
}
#define TM0(i) int64_t _t##i = nsnow()
#define TM1(i) do { tm_sect[i] += nsnow() - _t##i; tm_cnt[i]++; } while (0)
#else
#define TM0(i) do {} while (0)
#define TM1(i) do {} while (0)
#endif

#define NS_PER_SEC 1000000000LL
#define MTU 1500
#define HEADER 40
#define HARD_MAX_PKTS 64
#define PKT_SHIFT 26
#define INF_I64 (((int64_t)1) << 61)
#define T_NEVER_C (((int64_t)1) << 62)
#define KIND_DGRAM 6
#define TX_SIZE 400
/* stream unit kinds (network/unit.py order) */
#define TK_SYN 0
#define TK_SYNACK 1
#define TK_DATA 2
#define TK_ACK 3
#define TK_FIN 4
#define TK_FINACK 5

/* ---- threefry2x32-20 (ops/prng.py twin; Salmon et al. SC'11) ---------- */
static inline uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

static void threefry2x32_c(uint32_t k0, uint32_t k1, uint32_t c0, uint32_t c1,
                           uint32_t *o0, uint32_t *o1) {
  static const int ra[4] = {13, 15, 26, 6}, rb[4] = {17, 29, 16, 24};
  uint32_t ks[3];
  ks[0] = k0; ks[1] = k1; ks[2] = k0 ^ k1 ^ 0x1BD11BDAu;
  uint32_t x0 = c0 + ks[0], x1 = c1 + ks[1];
  for (int g = 0; g < 5; g++) {
    const int *rots = (g % 2 == 0) ? ra : rb;
    for (int i = 0; i < 4; i++) {
      x0 += x1;
      x1 = rotl32(x1, rots[i]);
      x1 ^= x0;
    }
    uint32_t j = (uint32_t)g + 1;
    x0 += ks[j % 3];
    x1 += ks[(j + 1) % 3] + j;
  }
  *o0 = x0; *o1 = x1;
}

/* fluid.loss_flags twin: unit dropped iff any of its first npk per-packet
 * draws lands under the threshold (draw = top 24 bits of x0). */
static int unit_dropped(uint64_t seed, uint64_t uid, int npk, uint32_t th) {
  if (!th) return 0;
  uint32_t k0 = (uint32_t)(seed & 0xFFFFFFFFu);
  uint32_t k1 = (uint32_t)(seed >> 32);
  uint32_t lo = (uint32_t)(uid & 0xFFFFFFFFu);
  uint32_t hi = (uint32_t)(uid >> 32);
  for (int p = 0; p < npk; p++) {
    uint32_t x0, x1;
    threefry2x32_c(k0, k1, lo, hi | ((uint32_t)p << PKT_SHIFT), &x0, &x1);
    if ((x0 >> 8) < th) return 1;
  }
  return 0;
}

/* ---- seen-set: open-addressing hash of short byte strings ------------- */
typedef struct {
  uint64_t *hash;  /* 0 = empty */
  uint32_t *off;
  uint16_t *len;
  size_t cap, count;
  char *arena;
  size_t alen, acap;
} SeenSet;

static uint64_t fnv1a(const char *s, Py_ssize_t n) {
  uint64_t h = 1469598103934665603ULL;
  for (Py_ssize_t i = 0; i < n; i++) {
    h ^= (unsigned char)s[i];
    h *= 1099511628211ULL;
  }
  return h | 1; /* never 0 (0 marks an empty slot) */
}

static int seen_init(SeenSet *s) {
  s->cap = 64; s->count = 0;
  s->hash = calloc(s->cap, sizeof(uint64_t));
  s->off = malloc(s->cap * sizeof(uint32_t));
  s->len = malloc(s->cap * sizeof(uint16_t));
  s->acap = 1024; s->alen = 0;
  s->arena = malloc(s->acap);
  if (!s->hash || !s->off || !s->len || !s->arena) return -1;
  return 0;
}

static void seen_free(SeenSet *s) {
  free(s->hash); free(s->off); free(s->len); free(s->arena);
  memset(s, 0, sizeof *s);
}

static int seen_contains(SeenSet *s, const char *k, Py_ssize_t n) {
  uint64_t h = fnv1a(k, n);
  size_t i = (size_t)h & (s->cap - 1);
  while (s->hash[i]) {
    if (s->hash[i] == h && s->len[i] == (uint16_t)n &&
        memcmp(s->arena + s->off[i], k, (size_t)n) == 0)
      return 1;
    i = (i + 1) & (s->cap - 1);
  }
  return 0;
}

static int seen_grow(SeenSet *s) {
  size_t ncap = s->cap * 2;
  uint64_t *nh = calloc(ncap, sizeof(uint64_t));
  uint32_t *no = malloc(ncap * sizeof(uint32_t));
  uint16_t *nl = malloc(ncap * sizeof(uint16_t));
  if (!nh || !no || !nl) { free(nh); free(no); free(nl); return -1; }
  for (size_t i = 0; i < s->cap; i++) {
    if (!s->hash[i]) continue;
    size_t j = (size_t)s->hash[i] & (ncap - 1);
    while (nh[j]) j = (j + 1) & (ncap - 1);
    nh[j] = s->hash[i]; no[j] = s->off[i]; nl[j] = s->len[i];
  }
  free(s->hash); free(s->off); free(s->len);
  s->hash = nh; s->off = no; s->len = nl; s->cap = ncap;
  return 0;
}

/* add if absent; returns 1 added, 0 already present, -1 on OOM */
static int seen_add(SeenSet *s, const char *k, Py_ssize_t n) {
  if (n > 0xFFFF) return -1;
  uint64_t h = fnv1a(k, n);
  size_t i = (size_t)h & (s->cap - 1);
  while (s->hash[i]) {
    if (s->hash[i] == h && s->len[i] == (uint16_t)n &&
        memcmp(s->arena + s->off[i], k, (size_t)n) == 0)
      return 0;
    i = (i + 1) & (s->cap - 1);
  }
  if (s->alen + (size_t)n > s->acap) {
    size_t ncap = s->acap * 2;
    while (ncap < s->alen + (size_t)n) ncap *= 2;
    char *na = realloc(s->arena, ncap);
    if (!na) return -1;
    s->arena = na; s->acap = ncap;
  }
  memcpy(s->arena + s->alen, k, (size_t)n);
  s->hash[i] = h; s->off[i] = (uint32_t)s->alen; s->len[i] = (uint16_t)n;
  s->alen += (size_t)n;
  s->count++;
  if (s->count * 10 >= s->cap * 7) {
    if (seen_grow(s) < 0) return -1;
  }
  return 1;
}

/* ---- interned attribute names ----------------------------------------- */
static PyObject *S_id, *S_now, *S_inbox, *S_egress_rows, *S_uid_counter,
    *S_emitters, *S_ev_key, *S_min_used_latency, *S_units_sent,
    *S_units_dropped, *S_units_blackholed, *S_bytes_sent, *S_device,
    *S_device_floor, *S_rows, *S_pos, *S_dispatch_row, *S_run_events,
    *S_popleft, *S_append, *S_ingress_deferred_rows, *S_pcap,
    *S_n_emitted, *S_n_delivered, *S_n_dgrams, *S_n_dgrams_recv,
    *S_n_events, *S_dispatch, *S_n_teardown, *S_n_blackholed, *S_down,
    *S_cc_id, *S_seed, *S_bootstrap_end, *S_unit_chunk,
    *S_socket_send_buffer, *S_socket_recv_buffer;

/* cached small objects */
static PyObject *O_zero, *O_one, *O_false, *O_kind_dgram;

/* read an int64 attribute (Python int) */
static int attr_i64(PyObject *o, PyObject *name, int64_t *out) {
  PyObject *v = PyObject_GetAttr(o, name);
  if (!v) return -1;
  *out = PyLong_AsLongLong(v);
  Py_DECREF(v);
  if (*out == -1 && PyErr_Occurred()) return -1;
  return 0;
}

static int attr_set_i64(PyObject *o, PyObject *name, int64_t v) {
  PyObject *pv = PyLong_FromLongLong(v);
  if (!pv) return -1;
  int r = PyObject_SetAttr(o, name, pv);
  Py_DECREF(pv);
  return r;
}

/* add a C delta into an int attribute (no-op for delta 0) */
static int attr_add_i64(PyObject *o, PyObject *name, int64_t d) {
  if (!d) return 0;
  int64_t cur;
  if (attr_i64(o, name, &cur) < 0) return -1;
  return attr_set_i64(o, name, cur + d);
}

/* tuple int helpers (no error checking beyond PyLong; rows are ours) */
static inline int64_t tup_i64(PyObject *t, Py_ssize_t i) {
  return PyLong_AsLongLong(PyTuple_GET_ITEM(t, i));
}

/* ---- per-host C state -------------------------------------------------- */
typedef struct {
  int64_t t, key;
  PyObject *payload; /* owned ref while in the inbox (NULL = no payload) */
  /* dispatch fields, fully packed (round 5: store rows no longer carry
   * a Python tuple at all on the C path; the 13-tuple is materialized
   * lazily only for Python-fallback dispatch / deferred parking) */
  int64_t nbytes, seq; /* stream dispatch: cum-ack / byte offset ride here */
  int32_t size, peer, bport, aport;
  int32_t frag, nfrags;
  int16_t kind;
} IRow;

struct GossipState_s;

/* packed per-row store record (CBatch.recs); field meanings match IRow */
typedef struct {
  int64_t t, key;
  int64_t nbytes, seq;
  int32_t tgt, size, peer, bport, aport;
  int32_t frag, nfrags;
  int16_t kind;
} SRec;

/* one egress row in a host's packed C egress buffer (the Host.emit_msg
 * tuple of the Python plane, without the tuple) */
typedef struct {
  int64_t size, t_emit, nbytes, seq;
  PyObject *payload; /* owned; NULL = None */
  int32_t kind, dst, sport, dport, frag, nfrags;
} ERow;

typedef struct {
  PyObject *host;      /* borrowed: Core->hosts list holds the ref */
  PyObject *id_obj;    /* owned: the host's stable `id` int object */
  PyObject *equeue;    /* owned: host.equeue (C timer push/cancel) */
  PyObject *heap;      /* owned: equeue._heap list */
  PyObject *live;      /* owned: equeue._live set */
  PyObject *cancelled; /* owned: equeue._cancelled set */
  /* cached heap root for the per-round due check: an OWNED ref to the
   * last-seen heap[0] plus its time. Owning the ref makes pointer
   * identity sound (the object cannot be freed and its address reused
   * while cached); if heap[0] is a different object, re-read. A root
   * that was cancelled in place keeps its time — a conservative lower
   * bound on the live head, which only costs a wasted scan, never a
   * missed event. */
  PyObject *head_cache;
  int64_t head_time;
  int py_mode;         /* pcap etc.: dispatch through Python run_events */
  PyObject *egress;    /* owned: host.egress_rows (identity-stable) */
  PyObject *conns;     /* owned: host._conns dict (identity-stable) */
  PyObject *listeners; /* owned: host._listeners dict (identity-stable) */
  PyObject *ack_eps;   /* owned: host._ack_eps dict (identity-stable:
                          cleared in place by the barrier, never rebound) */
  /* fault lifecycle (shadow_tpu/faults.py): crashed-host flag, mirrored
   * from Host.down by Core.host_crash/host_boot so the per-row dispatch
   * can discard arrivals at a dead NIC without an attribute read */
  int down;
  /* C-registered datagram ports (gossip); tiny linear table */
  int nports;
  int port[4];
  struct GossipState_s *gs[4];
  /* C inbox (filled by extract, consumed by run_host) */
  IRow *inbox;
  int inbox_n, inbox_cap, inbox_last_slice, inbox_multi;
  /* packed C egress buffer (emission-order; barrier consumes + clears) */
  ERow *erow;
  int erow_n, erow_cap;
  /* per-round counter deltas, flushed to host attrs after run_host */
  int64_t d_emitted, d_delivered, d_dgrams, d_dgrams_recv, d_events;
  /* stream-transport + routing counter deltas (host.counters keys) */
  int64_t d_sbytes_q, d_sbytes_recv, d_resets, d_unroutable;
  /* fault-accounting deltas (folded into the same attrs/counter keys the
   * Python twin maintains: _n_teardown/_n_blackholed and the
   * faults_active-gated stream recovery counters) */
  int64_t d_teardown, d_blackholed;
  int64_t d_fast_retx, d_rto_retx, d_timeouts, d_sack_retx;
  /* per-host congestion control (Host.cc_id, read at bind): dispatch
   * integer for the CongestionControl twin — endpoints the C SYN accept
   * creates must pick the same algorithm the Python accept would */
  int cc_kind;
} CHost;

typedef struct {
  PyObject_HEAD
  PyObject *plane;   /* borrowed: plane._c owns us (documented cycle-break) */
  PyObject *hosts;   /* owned list */
  PyObject *pending; /* owned deque */
  PyObject *deferred; /* owned set (plane._deferred) */
  PyObject *active;  /* owned set (controller._active), via bind_active */
  PyObject *storebatch_cls; /* owned: colplane.StoreBatch */
  /* numpy arrays: owned refs + raw pointers */
  PyObject *arrs[11];
  int64_t *tokens_down, *tbase, *tokens, *debt, *rate_up, *cap_up, *lat;
  int64_t *rate_down, *cap_down;
  uint32_t *thresh;
  int32_t *hostnode;
  int64_t H, G;
  uint64_t seed;
  int64_t bootstrap_end;
  int64_t unit_chunk; /* fluid quantum payload bytes (Host.unit_chunk) */
  int64_t sock_sbuf, sock_rbuf; /* experimental.socket_*_buffer */
  int mesh_mode; /* hand live batches to Python for the mesh collective */
  /* a faults: section exists (mirrors plane.faults_active): gates the
   * per-host blackhole/teardown accounting and the stream-recovery
   * counters, exactly like the Python twins gate on host.faults_active */
  int faults_active;
  /* multi-process sharding (parallel/shards.py): when shard_n > 1,
   * resolved store rows whose destination host id is not congruent to
   * shard_id (mod shard_n) divert into xout[dst % shard_n] — a Python
   * list of per-shard lists the plane owns — as 13-field store tuples,
   * instead of entering the local pending store. Counting (units_sent /
   * bytes_sent) stays with the RESOLVING shard. */
  int32_t shard_id, shard_n;
  PyObject *xout; /* owned; NULL until bind_shard */
  /* send-side packer (Core_take_xout_packed): when bind_shard receives
   * xout=None, diverted rows accumulate HERE as packed SRec + payload
   * refs and leave as shards.py wire-format byte blocks at the round
   * edge — no 13-field Python tuples on the cross-shard send path
   * (receive side was already packed via cbatch_from_packed). Buffers
   * are drained every round edge, so they are empty at every snapshot
   * boundary. Payload refs are owned (NULL = None). */
  int xpacked;
  SRec **xrecs;     /* [shard_n] growable per-destination-shard arrays */
  PyObject ***xpay; /* [shard_n] parallel payload refs */
  int *xn, *xcap;
  CHost *hs;
  /* scratch buffers reused across barriers */
  struct BRow *brow;
  int brow_cap;
  /* speculative forward windows (fused multi-round device windows): the
   * plane dispatches PREFIX-MIN threefry draws for FUTURE uids under
   * each host's recent npkts classes; the barrier's inline-draw loop
   * consults the installed table — uid-range + exact npkts match, and
   * dropped == (min_draw < thresh) for ANY thresh, so one speculated row
   * serves every destination. A stale or wrong guess falls back to the
   * inline threefry twin and can never change results. */
  struct SpecHost *spec;
  int spec_on;
  int64_t spec_hits, spec_draws; /* drained by Core_spec_stats */
  int32_t *spec_dq; /* demand queue: host ids awaiting a window */
  int spec_dq_n, spec_dq_cap;
  /* cached sorted snapshot of the active set (run_round's iteration
   * order). Valid while its length matches the set: discards happen
   * ONLY inside run_round (which updates both), so between rounds the
   * set can only GROW — a size match proves the contents are identical
   * and the per-round snapshot + qsort can be skipped entirely. */
  int64_t *act_ids;
  int64_t act_n;
  int64_t act_cap;
  /* ids added since the last refresh (extract's touched hosts and the
   * Python-side activate hook both land here): when the set size equals
   * act_n + pend_n, the refresh is a tiny sorted-merge instead of a
   * full iterate + qsort of the whole set */
  int64_t *act_pend;
  int64_t act_pend_n, act_pend_cap;
} CoreObject;

/* per-host speculative window + npkts class tracker. Two generations:
 * the live window [u0, u0+n) plus a staged continuation [nu0, nu0+nn)
 * prefetched when consumption passes 3/4 of the live one, so a steady
 * flow never sees a speculation gap while a wave is in flight. */
typedef struct SpecHost {
  uint64_t u0;          /* first speculated uid (live window) */
  int32_t n;            /* speculated draws per class */
  int32_t npk_a, npk_b; /* the INSTALLED window's npkts classes (bound to
                         * min_a/min_b at install; immutable until then) */
  uint32_t *min_a, *min_b; /* per-uid prefix-min 24-bit draws */
  uint64_t nu0; /* staged continuation window */
  int32_t nn;
  int32_t nnpk_a, nnpk_b;
  uint32_t *nmin_a, *nmin_b;
  uint8_t ready;    /* live mins consultable */
  uint8_t nready;   /* staged mins present */
  uint8_t inflight; /* demanded; a wave is being drawn */
  int32_t tnpk_a, tnpk_b; /* class TRACKER: two most-recent npkts (kept
                           * apart from the window labels — a transient
                           * third class must not invalidate good mins) */
  int32_t run;      /* live-draw momentum (halved on a class change) */
  int32_t want;     /* next window size (doubles on productive exhaust) */
} SpecHost;

#define SPEC_MIN_RUN 16  /* live draws before a host earns speculation */
#define SPEC_WANT0 128   /* first window size (units per class) */
#define SPEC_WANT_MAX 1024
/* classes cheaper than this many packet draws stay inline: a speculative
 * hit saves ~npk packet draws, and the consult itself is not free */
#define SPEC_MIN_NPK 4

/* one barrier row during assembly (all fields packed; `payload` is an
 * owned ref the barrier releases — or hands to the store — when done) */
typedef struct BRow {
  PyObject *payload; /* owned during assembly; NULL = None */
  PyObject *src_obj; /* borrowed (CHost.id_obj) */
  int32_t src, dst;
  int64_t size, t_emit, depart, arrival, key;
  int64_t nbytes, seq;
  uint64_t uid;
  uint32_t th;
  int32_t npk;
  int32_t kind, sport, dport, frag, nfrags;
  uint8_t drop;
} BRow;

/* ---- GossipState ------------------------------------------------------- */
typedef struct GossipState_s {
  PyObject_HEAD
  CoreObject *core; /* owned */
  int hid;
  int port;
  PyObject *port_obj;   /* owned cached PyLong(port) */
  int32_t *peers;
  int npeers;
  SeenSet seen;
  int64_t received_tx;
  int64_t next_dgram;
} GossipState;

/* forward decls */
static int core_emit_dgram(CoreObject *c, CHost *h, int64_t now, int dst,
                           GossipState *g, int dst_port, int64_t nbytes,
                           PyObject *payload);
static int gossip_on_msg_c(CoreObject *c, CHost *h, GossipState *g,
                           int64_t now, PyObject *payload, int64_t src_host);

/* ---- CBatch: a fully packed resolved store batch -----------------------
 * The C-path replacement for colplane.StoreBatch (round 5): no Python
 * row tuples — one SRec + one payload ref per row. Lives in
 * plane.pending next to (and duck-typing) StoreBatch: head_time() and
 * the consumed-prefix `pos` are the whole shared surface. Not
 * GC-tracked: payloads are bytes/None by the emission contract
 * (transport slices, gossip cells, model frames), which cannot form
 * reference cycles. */
typedef struct {
  PyObject_HEAD
  SRec *recs;
  PyObject **pay; /* owned refs; NULL = None */
  int n, pos;
} CBatch;

static void CBatch_dealloc(CBatch *b) {
  for (int i = 0; i < b->n; i++) Py_XDECREF(b->pay[i]);
  free(b->recs);
  free(b->pay);
  Py_TYPE(b)->tp_free((PyObject *)b);
}

static PyObject *CBatch_head_time(CBatch *b, PyObject *noarg) {
  (void)noarg;
  return PyLong_FromLongLong(b->pos < b->n ? b->recs[b->pos].t : T_NEVER_C);
}

static PyObject *CBatch_export_rows(CBatch *b, PyObject *noarg);
static PyObject *CBatch_restore_state(CBatch *b, PyObject *state);

static PyMethodDef CBatch_methods[] = {
    {"head_time", (PyCFunction)CBatch_head_time, METH_NOARGS,
     "earliest undelivered row time (StoreBatch.head_time twin)"},
    {"export_rows", (PyCFunction)CBatch_export_rows, METH_NOARGS,
     "checkpoint export: (pos, [13-tuple store rows]) — the plane-"
     "neutral StoreBatch form"},
    {"_restore_state", (PyCFunction)CBatch_restore_state, METH_O,
     "fill an empty CBatch from (pos, rows) — export_rows' inverse, "
     "also the plain-StoreBatch -> CBatch converter on C-plane resume"},
    {NULL, NULL, 0, NULL}};

static PyMemberDef CBatch_members[] = {
    {"pos", Py_T_INT, offsetof(CBatch, pos), 0, "consumed-prefix cursor"},
    {"n", Py_T_INT, offsetof(CBatch, n), Py_READONLY, "row count"},
    {NULL, 0, 0, 0, NULL}};

static PyTypeObject CBatch_Type = {
    PyVarObject_HEAD_INIT(NULL, 0).tp_name = "_colcore.CBatch",
    .tp_basicsize = sizeof(CBatch),
    .tp_dealloc = (destructor)CBatch_dealloc,
    .tp_flags = Py_TPFLAGS_DEFAULT,
    .tp_methods = CBatch_methods,
    .tp_members = CBatch_members,
    .tp_doc = "packed resolved store batch (StoreBatch twin, no tuples)",
};

static CBatch *cbatch_new(int n) {
  CBatch *b = PyObject_New(CBatch, &CBatch_Type);
  if (!b) return NULL;
  b->n = n;
  b->pos = 0;
  b->recs = malloc(sizeof(SRec) * (size_t)(n ? n : 1));
  b->pay = calloc((size_t)(n ? n : 1), sizeof(PyObject *));
  if (!b->recs || !b->pay) {
    free(b->recs); free(b->pay);
    b->recs = NULL; b->pay = NULL; b->n = 0;
    Py_DECREF(b);
    PyErr_NoMemory();
    return NULL;
  }
  return b;
}

/* materialize the colplane 13-tuple for one packed row (Python-fallback
 * dispatch, deferred parking, py_mode extraction) */
static PyObject *srec_tuple(const SRec *s, PyObject *payload) {
  PyObject *pl = payload ? payload : Py_None;
  return Py_BuildValue("(LLiiiiiLLiiiO)", (long long)s->t,
                       (long long)s->key, (int)s->tgt, (int)s->kind,
                       (int)s->peer, (int)s->aport, (int)s->bport,
                       (long long)s->nbytes, (long long)s->seq,
                       (int)s->frag, (int)s->nfrags, (int)s->size, pl);
}

static PyObject *irow_tuple(const CHost *h, const IRow *r, int64_t tgt);

/* ---- event-heap ops on EventQueue._heap (a PyList of 5-tuples) --------
 * Entries are (time, band, key, seq, task); (time, band, key, seq) is a
 * total order (seq unique), so any correct heap pops the same sequence as
 * Python's heapq — internal layout cannot affect results. */
static inline int heap_lt(PyObject *a, PyObject *b) {
  for (Py_ssize_t i = 0; i < 4; i++) {
    int64_t x = tup_i64(a, i), y = tup_i64(b, i);
    if (x != y) return x < y;
  }
  return 0;
}

/* pop the root of the heap list; returns an OWNED ref */
static PyObject *heap_pop(PyObject *heap) {
  Py_ssize_t n = PyList_GET_SIZE(heap);
  PyObject *last = PyList_GET_ITEM(heap, n - 1);
  Py_INCREF(last);
  if (PyList_SetSlice(heap, n - 1, n, NULL) < 0) {
    Py_DECREF(last);
    return NULL;
  }
  if (--n == 0) return last;
  PyObject *ret = PyList_GET_ITEM(heap, 0);
  Py_INCREF(ret);
  /* sift `last` down from the root */
  Py_ssize_t pos = 0;
  for (;;) {
    Py_ssize_t child = 2 * pos + 1;
    if (child >= n) break;
    if (child + 1 < n &&
        heap_lt(PyList_GET_ITEM(heap, child + 1), PyList_GET_ITEM(heap, child)))
      child++;
    PyObject *cobj = PyList_GET_ITEM(heap, child);
    if (!heap_lt(cobj, last)) break;
    Py_INCREF(cobj);
    PyList_SetItem(heap, pos, cobj); /* steals */
    pos = child;
  }
  PyList_SetItem(heap, pos, last); /* steals our ref to last */
  return ret;
}

/* heapq.heappush twin: append + sift-up with heap_lt. Steals the entry
 * ref. Identical resulting layout to heapq._siftdown (both shift each
 * passed parent down one level along the path and place the new entry at
 * its final slot). */
static int heap_push(PyObject *heap, PyObject *entry) {
  if (PyList_Append(heap, entry) < 0) { Py_DECREF(entry); return -1; }
  Py_DECREF(entry); /* the list holds it now */
  Py_ssize_t pos = PyList_GET_SIZE(heap) - 1;
  while (pos > 0) {
    Py_ssize_t parent = (pos - 1) >> 1;
    PyObject *pe = PyList_GET_ITEM(heap, parent);
    PyObject *ce = PyList_GET_ITEM(heap, pos);
    if (!heap_lt(ce, pe)) break;
    Py_INCREF(pe);
    Py_INCREF(ce);
    PyList_SetItem(heap, parent, ce); /* steals */
    PyList_SetItem(heap, pos, pe);    /* steals */
    pos = parent;
  }
  return 0;
}

/* EventQueue._drop_cancelled_head twin. Returns borrowed head or NULL
 * (empty); -1 via *err on failure. */
static PyObject *heap_head(CHost *h, int *err) {
  *err = 0;
  while (PyList_GET_SIZE(h->heap)) {
    PyObject *head = PyList_GET_ITEM(h->heap, 0);
    PyObject *seq = PyTuple_GET_ITEM(head, 3);
    int c = PySet_Contains(h->cancelled, seq);
    if (c < 0) { *err = 1; return NULL; }
    if (!c) return head;
    PyObject *popped = heap_pop(h->heap);
    if (!popped) { *err = 1; return NULL; }
    seq = PyTuple_GET_ITEM(popped, 3);
    if (PySet_Discard(h->cancelled, seq) < 0 ||
        PySet_Discard(h->live, seq) < 0) {
      Py_DECREF(popped); *err = 1; return NULL;
    }
    Py_DECREF(popped);
  }
  return NULL;
}

/* ---- emission (C gossip sendto -> egress row tuple) ------------------- */
static int core_emit_dgram_inner(CoreObject *c, CHost *h, int64_t now,
                           int dst, GossipState *g, int dst_port,
                           int64_t nbytes, PyObject *payload);
static int core_emit_dgram(CoreObject *c, CHost *h, int64_t now, int dst,
                           GossipState *g, int dst_port, int64_t nbytes,
                           PyObject *payload) {
  TM0(3);
  int r = core_emit_dgram_inner(c, h, now, dst, g, dst_port, nbytes, payload);
  TM1(3);
  return r;
}
/* packed emission core: append one ERow to the host's C egress buffer.
 * Mirrors Host.emit_msg's columnar branch without the tuple; payload is
 * INCREF'd (NULL/None accepted). */
static int core_emit_fields(CoreObject *c, CHost *h, int64_t now,
                            int kind, int dst, int64_t size, int64_t nbytes,
                            PyObject *payload, int64_t seq, int sport,
                            int dport, int frag, int nfrags) {
  if (h->erow_n == 0 && PyList_GET_SIZE(h->egress) == 0) {
    PyObject *em = PyObject_GetAttr(c->plane, S_emitters);
    if (!em) return -1;
    int r = PyList_Append(em, h->host);
    Py_DECREF(em);
    if (r < 0) return -1;
  }
  if (h->erow_n == h->erow_cap) {
    int ncap = h->erow_cap ? h->erow_cap * 2 : 32;
    ERow *nb = realloc(h->erow, sizeof(ERow) * (size_t)ncap);
    if (!nb) { PyErr_NoMemory(); return -1; }
    h->erow = nb;
    h->erow_cap = ncap;
  }
  ERow *e = &h->erow[h->erow_n++];
  e->kind = kind;
  e->dst = dst;
  e->size = size;
  e->t_emit = now;
  e->sport = sport;
  e->dport = dport;
  e->nbytes = nbytes;
  e->seq = seq;
  e->frag = frag;
  e->nfrags = nfrags;
  if (payload == Py_None) payload = NULL;
  Py_XINCREF(payload);
  e->payload = payload;
  h->d_emitted++;
  return 0;
}

static int core_emit_dgram_inner(CoreObject *c, CHost *h, int64_t now,
                           int dst, GossipState *g, int dst_port,
                           int64_t nbytes, PyObject *payload) {
  if (core_emit_fields(c, h, now, KIND_DGRAM, dst, nbytes + HEADER, nbytes,
                       payload, g->next_dgram++, g->port, dst_port, 0,
                       1) < 0)
    return -1;
  h->d_dgrams++;
  return 0;
}

/* egress-format 12-tuple for one ERow (the Python barrier's expected row
 * shape; used by materialize_egress and the device/mesh hand-off) */
static PyObject *erow_tuple(const ERow *e) {
  PyObject *pl = e->payload ? e->payload : Py_None;
  PyObject *t = Py_BuildValue("(iiLLiiLLiiO)", (int)e->kind, (int)e->dst,
                              (long long)e->size, (long long)e->t_emit,
                              (int)e->sport, (int)e->dport,
                              (long long)e->nbytes, (long long)e->seq,
                              (int)e->frag, (int)e->nfrags, pl);
  return t;
}

/* flush every host's packed C egress into its Python egress_rows list
 * (in emission order, ahead of any Python-appended rows? — there are
 * none: with the C engine attached every emission routes through
 * core_emit_fields, so egress_rows is empty until we fill it). Called
 * by colplane before its Python barrier paths (fault_filter rounds,
 * final flush) so those read the same rows they always did. */
static PyObject *Core_materialize_egress(CoreObject *c, PyObject *noarg) {
  (void)noarg;
  for (int64_t i = 0; i < c->H; i++) {
    CHost *h = &c->hs[i];
    if (!h->erow_n) continue;
    for (int j = 0; j < h->erow_n; j++) {
      ERow *e = &h->erow[j];
      PyObject *t = erow_tuple(e);
      if (!t) return NULL;
      int r = PyList_Append(h->egress, t);
      Py_DECREF(t);
      if (r < 0) return NULL;
      Py_XDECREF(e->payload);
      e->payload = NULL;
    }
    h->erow_n = 0;
  }
  Py_RETURN_NONE;
}

/* Python-callable packed emission (Host.emit_msg delegates here when the
 * C engine is attached; pcap capture stays on the Python side) */
static PyObject *Core_emit_row(CoreObject *c, PyObject *args) {
  long long hid, size, t_emit, nbytes, seq;
  int kind, dst, sport, dport, frag, nfrags;
  PyObject *payload;
  if (!PyArg_ParseTuple(args, "LiiLLiiLLiiO", &hid, &kind, &dst, &size,
                        &t_emit, &sport, &dport, &nbytes, &seq, &frag,
                        &nfrags, &payload))
    return NULL;
  if (hid < 0 || hid >= c->H || dst < 0 || dst >= c->H) {
    PyErr_SetString(PyExc_ValueError, "host id out of range");
    return NULL;
  }
  if (core_emit_fields(c, &c->hs[hid], t_emit, kind, dst, size, nbytes,
                       payload, seq, sport, dport, frag, nfrags) < 0)
    return NULL;
  Py_RETURN_NONE;
}

/* ---- the gossip model's hot half (models/gossip.py twin) --------------- */
static PyObject *msg_bytes(char kind, const char *txid, Py_ssize_t n) {
  PyObject *b = PyBytes_FromStringAndSize(NULL, n + 1);
  if (!b) return NULL;
  char *p = PyBytes_AS_STRING(b);
  p[0] = kind;
  memcpy(p + 1, txid, (size_t)n);
  return b;
}

static int gossip_announce(CoreObject *c, CHost *h, GossipState *g,
                           int64_t now, const char *txid, Py_ssize_t n,
                           int exclude) {
  PyObject *pl = msg_bytes('I', txid, n);
  if (!pl) return -1;
  int64_t nb = (n + 1) > 64 ? (n + 1) : 64;
  for (int i = 0; i < g->npeers; i++) {
    int p = g->peers[i];
    if (p == exclude) continue;
    if (core_emit_dgram(c, h, now, p, g, g->port, nb, pl) < 0) {
      Py_DECREF(pl);
      return -1;
    }
  }
  Py_DECREF(pl);
  return 0;
}

static int gossip_on_msg_c(CoreObject *c, CHost *h, GossipState *g,
                           int64_t now, PyObject *payload, int64_t src_host) {
  if (payload == Py_None) return 0;
  char *buf;
  Py_ssize_t len;
  if (PyBytes_AsStringAndSize(payload, &buf, &len) < 0) return -1;
  if (len < 1) return 0;
  char kind = buf[0];
  const char *txid = buf + 1;
  Py_ssize_t tn = len - 1;
  if (kind == 'I') {
    if (!seen_contains(&g->seen, txid, tn)) {
      PyObject *pl = msg_bytes('G', txid, tn);
      if (!pl) return -1;
      int64_t nb = (tn + 1) > 64 ? (tn + 1) : 64;
      int r = core_emit_dgram(c, h, now, (int)src_host, g, g->port, nb, pl);
      Py_DECREF(pl);
      return r;
    }
  } else if (kind == 'G') {
    PyObject *pl = msg_bytes('T', txid, tn);
    if (!pl) return -1;
    int64_t nb = (tn + 1) > TX_SIZE ? (tn + 1) : TX_SIZE;
    int r = core_emit_dgram(c, h, now, (int)src_host, g, g->port, nb, pl);
    Py_DECREF(pl);
    return r;
  } else if (kind == 'T') {
    int a = seen_add(&g->seen, txid, tn);
    if (a < 0) { PyErr_NoMemory(); return -1; }
    if (a == 1) {
      g->received_tx++;
      return gossip_announce(c, h, g, now, txid, tn, (int)src_host);
    }
  }
  return 0;
}

/* ---- row dispatch (Host.dispatch_row twin) ----------------------------
 * Returns 0 ok, -1 error. `*now` is the host's running clock; kept in C
 * and synced to host._now around any Python call-out. */
static int dispatch_stream(CoreObject *c, CHost *h, int hid, IRow *ir,
                           int64_t *now, int *now_dirty);

static int dispatch_c(CoreObject *c, CHost *h, int hid, IRow *ir,
                      int64_t *now, int *now_dirty) {
  int64_t t = ir->t;
  if (h->down) {
    /* crashed host (Host.dispatch_row twin): the arrival is consumed by
     * the dead NIC — clock advances, no token charge, no delivery */
    if (t > *now) { *now = t; *now_dirty = 1; }
    h->d_teardown++;
    return 0;
  }
  if (ir->kind <= TK_FINACK)
    return dispatch_stream(c, h, hid, ir, now, now_dirty);
  GossipState *g = NULL;
  if (ir->kind == KIND_DGRAM && ir->nfrags == 1) {
    for (int i = 0; i < h->nports; i++)
      if (h->port[i] == (int)ir->bport) { g = h->gs[i]; break; }
  }
  if (!g) {
    TM0(1);
    /* Python fallback: unregistered ports, frags. host.dispatch_row
     * does its own clock/bucket/deliver work (13-tuple materialized
     * here — the fallback is off the hot path by construction). */
    if (*now_dirty) {
      if (attr_set_i64(h->host, S_now, *now) < 0) return -1;
      *now_dirty = 0;
    }
    PyObject *row = irow_tuple(h, ir, hid);
    if (!row) return -1;
    PyObject *r = PyObject_CallMethodObjArgs(h->host, S_dispatch_row,
                                             row, NULL);
    Py_DECREF(row);
    if (!r) return -1;
    Py_DECREF(r);
    if (attr_i64(h->host, S_now, now) < 0) return -1;
    TM1(1);
    return 0;
  }
  if (t > *now) { *now = t; *now_dirty = 1; }
  if (t >= c->bootstrap_end) {
    if (c->tokens_down[hid] >= ir->size) {
      c->tokens_down[hid] -= ir->size;
    } else {
      /* park the whole row in the deferred backlog (Python structures,
       * drained by colplane._drain_deferred) */
      PyObject *dl = PyObject_GetAttr(h->host, S_ingress_deferred_rows);
      if (!dl) return -1;
      PyObject *row = irow_tuple(h, ir, hid);
      if (!row) { Py_DECREF(dl); return -1; }
      int r = PyList_Append(dl, row);
      Py_DECREF(row);
      Py_DECREF(dl);
      if (r < 0) return -1;
      if (PySet_Add(c->deferred, h->host) < 0) return -1;
      return 0;
    }
  }
  h->d_delivered++;
  h->d_dgrams_recv++;
  TM0(2);
  int rr = gossip_on_msg_c(c, h, g, *now,
                           ir->payload ? ir->payload : Py_None, ir->peer);
  TM1(2);
  return rr;
}

/* ---- Host.run_events twin over the C inbox ---------------------------- */
static int64_t run_host_inner(CoreObject *c, CHost *h, int hid, int64_t end);
static int64_t run_host_c(CoreObject *c, CHost *h, int hid, int64_t end) {
  TM0(4);
  int64_t r = run_host_inner(c, h, hid, end);
  TM1(4);
  return r;
}
static int64_t run_host_inner(CoreObject *c, CHost *h, int hid, int64_t end) {
  /* no entry clock read: inbox rows satisfy t >= host._now (rows are
   * extracted with t >= round_start and the clock never passes a round
   * boundary), heap tasks write the attr themselves, and the Python
   * dispatch fallback syncs before/after.  The attr is written back only
   * if a C dispatch advanced it (now_dirty). */
  int64_t now = INT64_MIN;
  int now_dirty = 0;
  int64_t n = 0;
  IRow *rows = h->inbox;
  int pos = 0, ln = h->inbox_n;
  int err = -1;
  /* fast path: no heap events at all */
  while (pos < ln && PyList_GET_SIZE(h->heap) == 0) {
    if (dispatch_c(c, h, hid, &rows[pos], &now, &now_dirty) < 0)
      goto done;
    pos++; n++;
  }
  if (PyList_GET_SIZE(h->heap)) {
    /* the inbox<->heap merge with a CACHED root: an owned ref to the
     * last-validated heap[0] plus its (t, band, key). While the root
     * object is unchanged, its triple is a lower bound on the live head
     * (a later cancel only moves the live head LATER), so a row that
     * beats the cached triple may dispatch without touching the
     * cancelled set; anything else re-validates through heap_head.
     * This turns the per-row cost of the hot merge from a set lookup +
     * four tuple reads into one pointer compare + int compares. */
    PyObject *h0own = NULL; /* owned: validated head at cache time */
    int64_t h0t = 0, h0band = 0, h0key = 0;
    int rcod2 = -1;
    for (;;) {
      if (h0own && pos < ln && PyList_GET_SIZE(h->heap) &&
          PyList_GET_ITEM(h->heap, 0) == h0own) {
        int64_t ti = rows[pos].t;
        if (ti < h0t ||
            (ti == h0t &&
             (0 < h0band || (0 == h0band && rows[pos].key < h0key)))) {
          if (dispatch_c(c, h, hid, &rows[pos], &now, &now_dirty) < 0)
            goto mdone;
          pos++; n++;
          continue;
        }
      }
      int herr;
      PyObject *h0 = heap_head(h, &herr);
      if (herr) goto mdone;
      int hv = 0;
      h0t = 0; h0band = 0; h0key = 0;
      if (h0) {
        Py_INCREF(h0);
        Py_XSETREF(h0own, h0);
        h0t = tup_i64(h0, 0);
        h0band = tup_i64(h0, 1);
        h0key = tup_i64(h0, 2);
        hv = h0t < end;
      } else {
        Py_CLEAR(h0own);
      }
      if (pos < ln) {
        int64_t ti = rows[pos].t;
        /* inbox rows are BAND_NET (0): they win same-time ties unless a
         * heap net event carries a smaller key */
        if (!hv || ti < h0t ||
            (ti == h0t &&
             (0 < h0band || (0 == h0band && rows[pos].key < h0key)))) {
          if (dispatch_c(c, h, hid, &rows[pos], &now, &now_dirty) < 0)
            goto mdone;
          pos++; n++;
          continue;
        }
      }
      if (hv) {
        PyObject *ev = heap_pop(h->heap);
        if (!ev) goto mdone;
        PyObject *seq = PyTuple_GET_ITEM(ev, 3);
        if (PySet_Discard(h->live, seq) < 0) { Py_DECREF(ev); goto mdone; }
        now = tup_i64(ev, 0);
        now_dirty = 0;
        if (attr_set_i64(h->host, S_now, now) < 0) { Py_DECREF(ev); goto mdone; }
        PyObject *res = PyObject_CallNoArgs(PyTuple_GET_ITEM(ev, 4));
        Py_DECREF(ev);
        if (!res) goto mdone;
        Py_DECREF(res);
        if (attr_i64(h->host, S_now, &now) < 0) goto mdone;
        n++;
        continue;
      }
      break;
    }
    rcod2 = 0;
  mdone:
    Py_XDECREF(h0own);
    if (rcod2 < 0) goto done;
  }
  err = 0;
done:;
  TM0(10);
  /* release the consumed prefix AND any unconsumed tail (error paths) */
  for (int i = 0; i < h->inbox_n; i++) Py_XDECREF(h->inbox[i].payload);
  h->inbox_n = 0;
  h->inbox_multi = 0;
  TM1(10);
  if (err) return -1;
  if (now_dirty && attr_set_i64(h->host, S_now, now) < 0) return -1;
  /* counter deltas stay C-side until Core.fold_counters (plane.flush_all):
   * the _n_* attrs are only read at finalize, and Python-path increments
   * commute with the fold */
  h->d_events += n;
  return n;
}

/* ---- Core.run_round: the controller's per-round host loop ------------- */
static int cmp_i64(const void *a, const void *b) {
  int64_t x = *(const int64_t *)a, y = *(const int64_t *)b;
  return (x > y) - (x < y);
}

/* record a newly-activated host id for the next refresh's merge */
static int act_pend_add(CoreObject *c, int64_t hid) {
  if (c->act_pend_n == c->act_pend_cap) {
    int64_t ncap = c->act_pend_cap ? c->act_pend_cap * 2 : 64;
    int64_t *nb = realloc(c->act_pend, sizeof(int64_t) * (size_t)ncap);
    if (!nb) { PyErr_NoMemory(); return -1; }
    c->act_pend = nb;
    c->act_pend_cap = ncap;
  }
  c->act_pend[c->act_pend_n++] = hid;
  return 0;
}

/* re-snapshot the active set when membership changed outside run_round.
 * When every addition was recorded in act_pend (extract + the activate
 * hook), the refresh is a merge of the small sorted pend batch into the
 * sorted snapshot; a residual size mismatch (additions that bypassed
 * the hook) falls back to the full iterate + qsort. */
static int act_refresh(CoreObject *c) {
  Py_ssize_t na = PySet_GET_SIZE(c->active);
  if ((int64_t)na == c->act_n) {
    c->act_pend_n = 0; /* pend entries were already merged or stale */
    return 0;
  }
  if (c->act_n >= 0 && (int64_t)na == c->act_n + c->act_pend_n) {
    int64_t pn = c->act_pend_n, an = c->act_n;
    if (an + pn > c->act_cap) {
      int64_t ncap = c->act_cap ? c->act_cap : 256;
      while (ncap < an + pn) ncap *= 2;
      int64_t *nb = realloc(c->act_ids, sizeof(int64_t) * (size_t)ncap);
      if (!nb) { PyErr_NoMemory(); return -1; }
      c->act_ids = nb;
      c->act_cap = ncap;
    }
    qsort(c->act_pend, (size_t)pn, sizeof(int64_t), cmp_i64);
    /* backward two-way merge into act_ids */
    int64_t i = an - 1, j = pn - 1, w = an + pn - 1;
    while (j >= 0) {
      if (i >= 0 && c->act_ids[i] > c->act_pend[j])
        c->act_ids[w--] = c->act_ids[i--];
      else
        c->act_ids[w--] = c->act_pend[j--];
    }
    c->act_n = an + pn;
    c->act_pend_n = 0;
    return 0;
  }
  c->act_pend_n = 0;
  if (na > c->act_cap) {
    int64_t ncap = c->act_cap ? c->act_cap : 256;
    while (ncap < na) ncap *= 2;
    int64_t *nb = realloc(c->act_ids, sizeof(int64_t) * (size_t)ncap);
    if (!nb) { PyErr_NoMemory(); return -1; }
    c->act_ids = nb;
    c->act_cap = ncap;
  }
  Py_ssize_t k2 = 0;
  PyObject *it = PyObject_GetIter(c->active);
  if (!it) return -1;
  PyObject *item;
  while ((item = PyIter_Next(it))) {
    if (k2 < na) c->act_ids[k2++] = PyLong_AsLongLong(item);
    Py_DECREF(item);
  }
  Py_DECREF(it);
  if (PyErr_Occurred()) return -1;
  qsort(c->act_ids, (size_t)k2, sizeof(int64_t), cmp_i64);
  c->act_n = k2;
  return 0;
}

/* min pending event time over the active hosts — the skip-ahead path's
 * `min(equeue.next_time() for active)` without a Python genexpr. Drops
 * cancelled heads exactly like EventQueue.next_time, so the returned
 * instant (and hence the round grid) is identical to the Python path. */
static PyObject *Core_next_time(CoreObject *c, PyObject *noarg) {
  (void)noarg;
  if (!c->active) {
    PyErr_SetString(PyExc_RuntimeError, "bind_active() not called");
    return NULL;
  }
  if (act_refresh(c) < 0) return NULL;
  int64_t best = T_NEVER_C;
  for (int64_t i = 0; i < c->act_n; i++) {
    int64_t hid = c->act_ids[i];
    if (hid < 0 || hid >= c->H) continue;
    int err;
    PyObject *head = heap_head(&c->hs[hid], &err);
    if (err) return NULL;
    if (head) {
      int64_t t = tup_i64(head, 0);
      if (t < best) best = t;
    }
  }
  return PyLong_FromLongLong(best);
}

/* ---- store construction (colplane._store_resolved twin) ---------------- */
typedef struct {
  int64_t t, key;
  int32_t idx;   /* index into the BRow array */
} ORow;

static int cmp_orow(const void *a, const void *b) {
  const ORow *x = a, *y = b;
  if (x->t != y->t) return (x->t > y->t) - (x->t < y->t);
  return (x->key > y->key) - (x->key < y->key);
}

/* build the sorted CBatch from resolved BRows (drop flags set);
 * have_flags=0 means every row survives.  Updates plane counters.
 * BRow payload refs are NOT consumed (the batch takes its own). */
static int store_build(CoreObject *c, BRow *rows, int n, int have_flags,
                       int64_t round_end) {
  int64_t sent = 0, dropped = 0, nbytes_total = 0;
  ORow *out = malloc(sizeof(ORow) * (size_t)(n ? n : 1));
  if (!out) { PyErr_NoMemory(); return -1; }
  int m = 0;
  int sh_n = c->shard_n;
  for (int i = 0; i < n; i++) {
    BRow *b = &rows[i];
    if (have_flags && b->drop) {
      dropped++;
    } else {
      sent++;
      nbytes_total += b->size;
      int64_t t = b->arrival;
      if (t < round_end) t = round_end;
      if (sh_n > 1 && b->dst % sh_n != c->shard_id) {
        /* cross-shard destination: divert the fully resolved store row
         * into the per-shard egress buffer the plane ships at the round
         * edge (parallel/shards.py) — packed SRec when the plane bound
         * the packed send path, 13-field tuple otherwise */
        SRec s;
        s.t = t; s.key = b->key; s.tgt = b->dst; s.size = (int32_t)b->size;
        s.peer = b->src; s.bport = b->dport; s.aport = b->sport;
        s.nbytes = b->nbytes; s.seq = b->seq; s.kind = (int16_t)b->kind;
        s.frag = b->frag; s.nfrags = b->nfrags;
        int j = b->dst % sh_n;
        if (c->xpacked) {
          if (c->xn[j] == c->xcap[j]) {
            int nc = c->xcap[j] ? c->xcap[j] * 2 : 256;
            SRec *nr = realloc(c->xrecs[j], sizeof(SRec) * (size_t)nc);
            if (!nr) { free(out); PyErr_NoMemory(); return -1; }
            c->xrecs[j] = nr;
            PyObject **npp =
                realloc(c->xpay[j], sizeof(PyObject *) * (size_t)nc);
            if (!npp) { free(out); PyErr_NoMemory(); return -1; }
            c->xpay[j] = npp;
            c->xcap[j] = nc;
          }
          c->xrecs[j][c->xn[j]] = s;
          Py_XINCREF(b->payload);
          c->xpay[j][c->xn[j]] = b->payload;
          c->xn[j]++;
          continue;
        }
        PyObject *row_t = srec_tuple(&s, b->payload);
        if (!row_t) { free(out); return -1; }
        PyObject *lst = PyList_GET_ITEM(c->xout, j);
        int rc3 = PyList_Append(lst, row_t);
        Py_DECREF(row_t);
        if (rc3 < 0) { free(out); return -1; }
        continue;
      }
      out[m].t = t; out[m].key = b->key; out[m].idx = i;
      m++;
    }
  }
  int rc = -1;
  PyObject *sb = NULL, *ap = NULL;
  if (m) {
    qsort(out, (size_t)m, sizeof(ORow), cmp_orow);
    CBatch *cb = cbatch_new(m);
    if (!cb) goto done;
    sb = (PyObject *)cb;
    for (int i = 0; i < m; i++) {
      BRow *b = &rows[out[i].idx];
      SRec *rc2 = &cb->recs[i];
      rc2->t = out[i].t;
      rc2->key = out[i].key;
      rc2->tgt = b->dst;
      rc2->size = (int32_t)b->size;
      rc2->peer = b->src;
      rc2->bport = b->dport;
      rc2->aport = b->sport;
      rc2->nbytes = b->nbytes;
      rc2->seq = b->seq;
      rc2->kind = (int16_t)b->kind;
      rc2->frag = b->frag;
      rc2->nfrags = b->nfrags;
      Py_XINCREF(b->payload);
      cb->pay[i] = b->payload;
    }
    ap = PyObject_CallMethodObjArgs(c->pending, S_append, sb, NULL);
    if (!ap) goto done;
  }
  if (attr_add_i64(c->plane, S_units_sent, sent) < 0 ||
      attr_add_i64(c->plane, S_units_dropped, dropped) < 0 ||
      attr_add_i64(c->plane, S_bytes_sent, nbytes_total) < 0)
    goto done;
  rc = 0;
done:
  Py_XDECREF(ap);
  Py_XDECREF(sb);
  free(out);
  return rc;
}

/* Python-callable twin of colplane._store_resolved: used by the device
 * flush path (flags arrive from a DrawHandle readback). */
static PyObject *Core_store_resolved(CoreObject *c, PyObject *args) {
  PyObject *rows, *src_l, *arrival_l, *keys_l, *flags;
  long long round_end;
  if (!PyArg_ParseTuple(args, "OOOOOL", &rows, &src_l, &arrival_l, &keys_l,
                        &flags, &round_end))
    return NULL;
  if (!PyList_Check(rows) || !PyList_Check(src_l) || !PyList_Check(arrival_l)
      || !PyList_Check(keys_l)) {
    PyErr_SetString(PyExc_TypeError, "store_resolved expects lists");
    return NULL;
  }
  int n = (int)PyList_GET_SIZE(rows);
  int have_flags = flags != Py_None;
  BRow *br = malloc(sizeof(BRow) * (size_t)(n ? n : 1));
  if (!br) return PyErr_NoMemory();
  for (int i = 0; i < n; i++) {
    PyObject *er = PyList_GET_ITEM(rows, i);
    BRow *b = &br[i];
    /* egress-format tuple -> packed fields (payload ref stays borrowed
     * from the tuple; store_build takes its own) */
    b->kind = (int32_t)tup_i64(er, 0);
    b->src = (int32_t)PyLong_AsLongLong(PyList_GET_ITEM(src_l, i));
    b->dst = (int32_t)tup_i64(er, 1);
    b->size = tup_i64(er, 2);
    b->t_emit = tup_i64(er, 3);
    b->sport = (int32_t)tup_i64(er, 4);
    b->dport = (int32_t)tup_i64(er, 5);
    b->nbytes = tup_i64(er, 6);
    b->seq = tup_i64(er, 7);
    b->frag = (int32_t)tup_i64(er, 8);
    b->nfrags = (int32_t)tup_i64(er, 9);
    PyObject *pl = PyTuple_GET_ITEM(er, 10);
    b->payload = pl == Py_None ? NULL : pl;
    b->arrival = PyLong_AsLongLong(PyList_GET_ITEM(arrival_l, i));
    b->key = PyLong_AsLongLong(PyList_GET_ITEM(keys_l, i));
    if (b->src < 0 || b->src >= c->H) {
      free(br);
      if (!PyErr_Occurred())
        PyErr_SetString(PyExc_ValueError, "src host id out of range");
      return NULL;
    }
    b->src_obj = c->hs[b->src].id_obj;
    b->drop = 0;
    if (have_flags) {
      int d = PyObject_IsTrue(PyList_GET_ITEM(flags, i));
      if (d < 0) { free(br); return NULL; }
      b->drop = (uint8_t)d;
    }
  }
  if (PyErr_Occurred()) { free(br); return NULL; }
  int rc = store_build(c, br, n, have_flags, round_end);
  free(br);
  if (rc < 0) return NULL;
  Py_RETURN_NONE;
}

/* ---- the round barrier (colplane end_of_round twin, fifo qdisc) -------- */
typedef struct { int64_t hid; PyObject *host; } Emitter;

static int cmp_emitter(const void *a, const void *b) {
  int64_t x = ((const Emitter *)a)->hid, y = ((const Emitter *)b)->hid;
  return (x > y) - (x < y);
}

/* closed-form token buckets (fluid.TokenBuckets twin, lazy rebase like
 * depart_times_scalar — outcome-identical to the full-rebase vector path,
 * see fluid.py docstrings).  brow[] must be sorted by src (it is: the
 * emitters are sorted and each contributes one contiguous segment). */
static void depart_closed_form(CoreObject *c, BRow *br, int n,
                               int64_t t_now) {
  int i = 0;
  while (i < n) {
    int32_t s = br[i].src;
    int64_t rate = c->rate_up[s], cap = c->cap_up[s];
    /* lazy rebase at the barrier instant */
    int64_t dt = t_now - c->tbase[s];
    int64_t q = dt / NS_PER_SEC, r = dt % NS_PER_SEC;
    int64_t avail = c->tokens[s] + rate * q +
                    (int64_t)((uint64_t)rate * (uint64_t)r /
                              (uint64_t)NS_PER_SEC) -
                    c->debt[s];
    if (avail > cap) {
      c->tbase[s] = t_now;
      c->tokens[s] = cap;
      c->debt[s] = 0;
    }
    int64_t tb = c->tbase[s], tok = c->tokens[s], debt = c->debt[s];
    int64_t cum = 0;
    int j = i;
    for (; j < n && br[j].src == s; j++) {
      cum += br[j].size;
      int64_t need = debt + cum - tok;
      int64_t tready = 0;
      if (need > 0) {
        int64_t q2 = need / rate, r2 = need % rate;
        tready = tb + q2 * NS_PER_SEC +
                 (int64_t)(((uint64_t)r2 * (uint64_t)NS_PER_SEC +
                            (uint64_t)rate - 1) /
                           (uint64_t)rate);
      }
      br[j].depart = br[j].t_emit > tready ? br[j].t_emit : tready;
    }
    c->debt[s] = debt + cum;
    i = j;
  }
}

/* ---- speculative forward windows -------------------------------------- */
static void spec_enqueue(CoreObject *c, int32_t hid) {
  SpecHost *s = &c->spec[hid];
  if (s->inflight) return;
  if (c->spec_dq_n == c->spec_dq_cap) {
    int ncap = c->spec_dq_cap ? c->spec_dq_cap * 2 : 256;
    int32_t *nq = realloc(c->spec_dq, sizeof(int32_t) * (size_t)ncap);
    if (!nq) return; /* no memory: simply don't speculate */
    c->spec_dq = nq;
    c->spec_dq_cap = ncap;
  }
  s->inflight = 1;
  c->spec_dq[c->spec_dq_n++] = hid;
}

/* One live unit at the inline-draw point: track its npkts class, consult
 * the host's speculative window (dropped == min_draw < thresh), and file
 * demand when the host has earned a (larger) window. Returns the drop
 * flag (0/1) on a verified hit, -1 on a miss (caller draws inline). */
static inline int spec_consult(CoreObject *c, BRow *b) {
  SpecHost *s = &c->spec[b->src];
  if (s->tnpk_a == b->npk) {
    s->run++;
  } else if (s->tnpk_b == b->npk) {
    /* keep A = most recent: swap so two alternating classes (full data
     * units one way, single-packet acks the other) both stay tracked */
    int32_t tn = s->tnpk_a;
    s->tnpk_a = s->tnpk_b;
    s->tnpk_b = tn;
    s->run++;
  } else {
    s->tnpk_b = s->tnpk_a;
    s->tnpk_a = b->npk;
    s->run >>= 1; /* momentum survives an occasional odd-sized unit */
  }
  if (s->ready && b->uid >= s->u0 + (uint64_t)s->n && s->nready) {
    /* live window exhausted with a staged continuation: promote it */
    free(s->min_a);
    free(s->min_b);
    s->u0 = s->nu0;
    s->n = s->nn;
    s->min_a = s->nmin_a;
    s->min_b = s->nmin_b;
    /* the tracker classes may have drifted since the stage was demanded;
     * consult below matches against the STAGED classes */
    s->npk_a = s->nnpk_a;
    s->npk_b = s->nnpk_b;
    s->nmin_a = s->nmin_b = NULL;
    s->nready = 0;
    if (s->want < SPEC_WANT_MAX) s->want *= 2;
  }
  if (s->ready) {
    uint64_t off = b->uid - s->u0;
    if (off < (uint64_t)s->n) {
      uint32_t *mins = (b->npk == s->npk_a) ? s->min_a
                       : (b->npk == s->npk_b) ? s->min_b
                                              : NULL;
      if (!s->nready && !s->inflight && s->run >= SPEC_MIN_RUN
          && off >= (uint64_t)(s->n - (s->n >> 2)))
        spec_enqueue(c, b->src); /* 3/4 consumed: prefetch continuation */
      if (mins) return mins[off] < b->th;
    } else if (b->uid >= s->u0 + (uint64_t)s->n) {
      /* window exhausted with nothing staged: it produced hits, so
       * double the next one */
      free(s->min_a);
      free(s->min_b);
      s->min_a = s->min_b = NULL;
      s->ready = 0;
      if (s->want < SPEC_WANT_MAX) s->want *= 2;
      if (s->run >= SPEC_MIN_RUN) spec_enqueue(c, b->src);
    }
  } else if (!s->inflight && s->run >= SPEC_MIN_RUN
             && (s->tnpk_a >= SPEC_MIN_NPK
                 || s->tnpk_b >= SPEC_MIN_NPK)) {
    if (!s->want) s->want = SPEC_WANT0;
    spec_enqueue(c, b->src);
  }
  return -1;
}

static PyObject *Core_spec_demand(CoreObject *c, PyObject *args) {
  int min_hosts = 1;
  if (!PyArg_ParseTuple(args, "|i", &min_hosts)) return NULL;
  if (!c->spec) {
    /* first call from the plane turns speculation on (the plane only
     * calls once a device has published) */
    c->spec = calloc((size_t)c->H, sizeof(SpecHost));
    if (!c->spec) return PyErr_NoMemory();
    c->spec_on = 1;
    Py_RETURN_NONE;
  }
  /* demand coalescing: waves amortize a fixed dispatch cost, so hold the
   * queue until a worthwhile cohort forms (the plane forces min_hosts=1
   * on a coarse age cadence so stragglers still get windows) */
  if (c->spec_dq_n < min_hosts) Py_RETURN_NONE;
  int n = c->spec_dq_n;
  npy_intp dims[1] = {n};
  PyObject *hosts = PyArray_SimpleNew(1, dims, NPY_INT32);
  PyObject *u0 = PyArray_SimpleNew(1, dims, NPY_UINT64);
  PyObject *cnt = PyArray_SimpleNew(1, dims, NPY_INT32);
  PyObject *npka = PyArray_SimpleNew(1, dims, NPY_INT32);
  PyObject *npkb = PyArray_SimpleNew(1, dims, NPY_INT32);
  if (!hosts || !u0 || !cnt || !npka || !npkb) {
    Py_XDECREF(hosts); Py_XDECREF(u0); Py_XDECREF(cnt); Py_XDECREF(npka);
    Py_XDECREF(npkb);
    return NULL;
  }
  int32_t *ph = PyArray_DATA((PyArrayObject *)hosts);
  uint64_t *pu = PyArray_DATA((PyArrayObject *)u0);
  int32_t *pn = PyArray_DATA((PyArrayObject *)cnt);
  int32_t *pna = PyArray_DATA((PyArrayObject *)npka);
  int32_t *pnb = PyArray_DATA((PyArrayObject *)npkb);
  int out_n = 0;
  for (int i = 0; i < n; i++) {
    int32_t hid = c->spec_dq[i];
    SpecHost *s = &c->spec[hid];
    if (s->tnpk_a < SPEC_MIN_NPK && s->tnpk_b < SPEC_MIN_NPK) {
      /* classes drifted cheap since enqueue: a wave row would be
       * filtered plane-side and the host's inflight flag would stick —
       * release it here instead so it can re-demand later */
      s->inflight = 0;
      continue;
    }
    if (s->ready) {
      /* prefetch: the staged window continues the live one seamlessly */
      pu[out_n] = s->u0 + (uint64_t)s->n;
    } else {
      int64_t ctr;
      if (attr_i64(c->hs[hid].host, S_uid_counter, &ctr) < 0) {
        Py_DECREF(hosts); Py_DECREF(u0); Py_DECREF(cnt); Py_DECREF(npka);
        Py_DECREF(npkb);
        return NULL;
      }
      /* the window starts at the host's NEXT uid: only future units */
      pu[out_n] = ((uint64_t)hid << 32) | (uint64_t)ctr;
    }
    ph[out_n] = hid;
    pn[out_n] = s->want;
    pna[out_n] = s->tnpk_a;
    pnb[out_n] = s->tnpk_b;
    out_n++;
  }
  c->spec_dq_n = 0;
  if (out_n == 0) {
    Py_DECREF(hosts); Py_DECREF(u0); Py_DECREF(cnt); Py_DECREF(npka);
    Py_DECREF(npkb);
    Py_RETURN_NONE;
  }
  if (out_n < n) {
    /* shrink to the kept cohort (cheap-class hosts were released) */
    PyArray_Dims nd = {.ptr = (npy_intp[]){out_n}, .len = 1};
    PyObject *tmp;
#define SHRINK(arr) \
    tmp = PyArray_Resize((PyArrayObject *)(arr), &nd, 0, NPY_CORDER); \
    if (!tmp) { \
      Py_DECREF(hosts); Py_DECREF(u0); Py_DECREF(cnt); Py_DECREF(npka); \
      Py_DECREF(npkb); \
      return NULL; \
    } \
    Py_DECREF(tmp);
    SHRINK(hosts) SHRINK(u0) SHRINK(cnt) SHRINK(npka) SHRINK(npkb)
#undef SHRINK
  }
  return Py_BuildValue("(NNNNN)", hosts, u0, cnt, npka, npkb);
}

static PyObject *Core_spec_install(CoreObject *c, PyObject *args) {
  PyObject *hosts, *u0, *cnt, *npka, *npkb, *offa, *offb, *mins;
  if (!PyArg_ParseTuple(args, "OOOOOOOO", &hosts, &u0, &cnt, &npka, &npkb,
                        &offa, &offb, &mins))
    return NULL;
  if (!c->spec) Py_RETURN_NONE;
#define DATA(o) PyArray_DATA((PyArrayObject *)(o))
  int n = (int)PyArray_SIZE((PyArrayObject *)hosts);
  int32_t *ph = DATA(hosts);
  uint64_t *pu = DATA(u0);
  int32_t *pn = DATA(cnt);
  int32_t *pna = DATA(npka);
  int32_t *pnb = DATA(npkb);
  int64_t *poa = DATA(offa);
  int64_t *pob = DATA(offb);
  uint32_t *pm = DATA(mins);
  int64_t mlen = (int64_t)PyArray_SIZE((PyArrayObject *)mins);
#undef DATA
  for (int i = 0; i < n; i++) {
    int32_t hid = ph[i];
    if (hid < 0 || hid >= c->H) continue;
    SpecHost *s = &c->spec[hid];
    s->inflight = 0;
    /* the class tracker may have moved on while the wave was in flight;
     * install anyway — consult verifies uid range + npkts per unit, so a
     * stale class simply never hits */
    int64_t ni = pn[i];
    if (ni <= 0) continue;
    uint32_t *ma = NULL, *mb = NULL;
    size_t nbytes = sizeof(uint32_t) * (size_t)ni;
    if (poa[i] >= 0 && poa[i] + ni <= mlen) {
      ma = malloc(nbytes);
      if (ma) memcpy(ma, pm + poa[i], nbytes);
    }
    if (pob[i] >= 0 && pob[i] + ni <= mlen) {
      mb = malloc(nbytes);
      if (mb) memcpy(mb, pm + pob[i], nbytes);
    }
    if (!ma && !mb) continue;
    if (s->ready && pu[i] == s->u0 + (uint64_t)s->n) {
      /* continuation of a still-live window: stage it */
      free(s->nmin_a);
      free(s->nmin_b);
      s->nu0 = pu[i];
      s->nn = (int32_t)ni;
      s->nnpk_a = pna[i];
      s->nnpk_b = pnb[i];
      s->nmin_a = ma;
      s->nmin_b = mb;
      s->nready = 1;
    } else {
      free(s->min_a);
      free(s->min_b);
      free(s->nmin_a);
      free(s->nmin_b);
      s->nmin_a = s->nmin_b = NULL;
      s->nready = 0;
      s->u0 = pu[i];
      s->n = (int32_t)ni;
      s->npk_a = pna[i];
      s->npk_b = pnb[i];
      s->min_a = ma;
      s->min_b = mb;
      s->ready = 1;
    }
  }
  Py_RETURN_NONE;
}

static PyObject *Core_spec_stats(CoreObject *c, PyObject *noarg) {
  (void)noarg;
  PyObject *r = Py_BuildValue("(LL)", (long long)c->spec_hits,
                              (long long)c->spec_draws);
  c->spec_hits = 0;
  c->spec_draws = 0;
  return r;
}

static PyObject *Core_barrier(CoreObject *c, PyObject *args) {
  long long rs_ll, re_ll;
  if (!PyArg_ParseTuple(args, "LL", &rs_ll, &re_ll)) return NULL;
  int64_t round_start = rs_ll, round_end = re_ll;
  PyObject *emitters = PyObject_GetAttr(c->plane, S_emitters);
  if (!emitters) return NULL;
  Py_ssize_t nem = PyList_Check(emitters) ? PyList_GET_SIZE(emitters) : -1;
  if (nem < 0) {
    Py_DECREF(emitters);
    PyErr_SetString(PyExc_TypeError, "plane.emitters is not a list");
    return NULL;
  }
  if (nem == 0) {
    Py_DECREF(emitters);
    Py_RETURN_NONE;
  }
  PyObject *fresh = PyList_New(0);
  if (!fresh) { Py_DECREF(emitters); return NULL; }
  int rc_set = PyObject_SetAttr(c->plane, S_emitters, fresh);
  Py_DECREF(fresh);
  if (rc_set < 0) { Py_DECREF(emitters); return NULL; }

  PyObject *result = NULL; /* NULL = error until set */
  int n = 0;    /* rows collected */
  int nown = 0; /* rows currently OWNED in brow[0..nown) (refcounts) */
  Emitter *ems = malloc(sizeof(Emitter) * (size_t)nem);
  if (!ems) { PyErr_NoMemory(); goto done; }
  for (Py_ssize_t i = 0; i < nem; i++) {
    ems[i].host = PyList_GET_ITEM(emitters, i);
    if (attr_i64(ems[i].host, S_id, &ems[i].hid) < 0) goto done;
  }
  if (nem > 1) qsort(ems, (size_t)nem, sizeof(Emitter), cmp_emitter);

  /* collect rows + mint uids in per-host emission order (the packed C
   * egress buffers; ownership of each payload ref moves to the BRow) */
  for (Py_ssize_t e = 0; e < nem; e++) {
    int64_t hid = ems[e].hid;
    CHost *hstate = &c->hs[hid];
    if (PyList_GET_SIZE(hstate->egress) != 0) {
      /* every emission on the C plane routes through core_emit_fields /
       * emit_row; a tuple here means a writer bypassed the packed path */
      PyErr_SetString(PyExc_RuntimeError,
                      "host.egress_rows is non-empty under the C engine "
                      "(packed-emission protocol violation)");
      goto done;
    }
    Py_ssize_t k = hstate->erow_n;
    if (n + k > c->brow_cap) {
      int ncap = c->brow_cap ? c->brow_cap : 4096;
      while (ncap < n + k) ncap *= 2;
      BRow *nb = realloc(c->brow, sizeof(BRow) * (size_t)ncap);
      if (!nb) { PyErr_NoMemory(); goto done; }
      c->brow = nb;
      c->brow_cap = ncap;
    }
    int64_t ctr;
    if (attr_i64(ems[e].host, S_uid_counter, &ctr) < 0) goto done;
    if (attr_set_i64(ems[e].host, S_uid_counter, ctr + k) < 0) goto done;
    uint64_t base = ((uint64_t)hid << 32) | (uint64_t)ctr;
    for (Py_ssize_t i = 0; i < k; i++) {
      ERow *er = &hstate->erow[i];
      BRow *b = &c->brow[n++];
      b->payload = er->payload; /* ownership moves */
      er->payload = NULL;
      b->src_obj = hstate->id_obj;
      b->src = (int32_t)hid;
      b->dst = er->dst;
      b->size = er->size;
      b->t_emit = er->t_emit;
      b->nbytes = er->nbytes;
      b->seq = er->seq;
      b->kind = er->kind;
      b->sport = er->sport;
      b->dport = er->dport;
      b->frag = er->frag;
      b->nfrags = er->nfrags;
      b->uid = base + (uint64_t)i;
      b->drop = 0;
    }
    hstate->erow_n = 0;
    nown = n;
  }
  if (n == 0) { result = Py_None; Py_INCREF(Py_None); goto done; }

  /* departures on the FULL batch (buckets charge for blackholed units
   * too, matching the host planes) */
  if (round_start < c->bootstrap_end) {
    for (int i = 0; i < n; i++) c->brow[i].depart = c->brow[i].t_emit;
  } else {
    depart_closed_form(c, c->brow, n, round_start);
  }

  /* blackhole filter + latency/threshold gather + keys */
  int64_t key0;
  if (attr_i64(c->plane, S_ev_key, &key0) < 0) goto done;
  int64_t mul;
  if (attr_i64(c->plane, S_min_used_latency, &mul) < 0) goto done;
  int keep = 0;
  int64_t bh = 0;
  int any_live = 0;
  for (int i = 0; i < n; i++) {
    BRow *b = &c->brow[i];
    int32_t sn = c->hostnode[b->src], dn = c->hostnode[b->dst];
    int64_t lat = c->lat[(int64_t)sn * c->G + dn];
    if (lat >= INF_I64) {
      bh++;
      if (c->faults_active) c->hs[b->src].d_blackholed++;
      Py_XDECREF(b->payload); /* blackholed: drop our ref (see `nown`) */
      continue;
    }
    if (lat < mul) mul = lat;
    b->arrival = b->depart + lat;
    /* canonical event key = the uid (placement-independent; the Python
     * planes' twin — engine.py/colplane.py). _ev_key stays a resolved-
     * units counter (hashed by the determinism sentinel). */
    b->key = (int64_t)b->uid;
    b->th = c->thresh[(int64_t)sn * c->G + dn];
    if (b->th) any_live = 1;
    int64_t q = (b->size + MTU - 1) / MTU;
    b->npk = (int32_t)(q < 1 ? 1 : (q > HARD_MAX_PKTS ? HARD_MAX_PKTS : q));
    if (keep != i) c->brow[keep] = *b;
    keep++;
  }
  /* after compaction exactly brow[0..keep) carry owned refs; the stale
   * tail copies must never be released (review r4 finding #1) */
  nown = keep;
  if (attr_set_i64(c->plane, S_ev_key, key0 + keep) < 0) goto done;
  if (attr_add_i64(c->plane, S_units_blackholed, bh) < 0) goto done;
  if (attr_set_i64(c->plane, S_min_used_latency, mul) < 0) goto done;
  if (keep == 0) { result = Py_None; Py_INCREF(Py_None); goto done; }
  /* from here on a non-device barrier returns True ("stored kept rows"),
   * so the Python wrapper ticks the device-floor cooldown only on rounds
   * that actually bypassed the device — matching the vector twin, which
   * never ticks on empty rounds */

  /* hand-off paths: the Python machinery takes over with arrays we
   * build — mesh mode hands EVERY post-bootstrap batch to the lazy
   * collective (plus src/dst arrays); device mode hands big live
   * batches to the draw plane */
  /* dead batches (no loss anywhere) store inline even in mesh mode —
   * the collective would only confirm all-false flags */
  int mesh_off = c->mesh_mode && round_start >= c->bootstrap_end && any_live;
  if (any_live) {
    PyObject *device = PyObject_GetAttr(c->plane, S_device);
    if (!device) goto done;
    int have_dev = device != Py_None;
    Py_DECREF(device);
    if (have_dev || mesh_off) {
      double floor_d = 0.0;
      if (!mesh_off) {
        PyObject *fl = PyObject_GetAttr(c->plane, S_device_floor);
        if (!fl) goto done;
        floor_d = PyFloat_AsDouble(fl);
        Py_DECREF(fl);
        if (floor_d == -1.0 && PyErr_Occurred()) goto done;
      }
      if (mesh_off || (double)keep >= floor_d) {
        npy_intp dims[1] = {keep};
        PyObject *rows_l = PyList_New(keep);
        PyObject *src_l = PyList_New(keep);
        PyObject *keys_l = PyList_New(keep);
        PyObject *arr_t = PyArray_SimpleNew(1, dims, NPY_INT64);
        PyObject *arr_lo = PyArray_SimpleNew(1, dims, NPY_UINT32);
        PyObject *arr_hi = PyArray_SimpleNew(1, dims, NPY_UINT32);
        PyObject *arr_npk = PyArray_SimpleNew(1, dims, NPY_UINT32);
        PyObject *arr_th = PyArray_SimpleNew(1, dims, NPY_UINT32);
        PyObject *arr_src = NULL, *arr_dst = NULL;
        if (mesh_off) {
          arr_src = PyArray_SimpleNew(1, dims, NPY_INT32);
          arr_dst = PyArray_SimpleNew(1, dims, NPY_INT32);
        }
        if (!rows_l || !src_l || !keys_l || !arr_t || !arr_lo || !arr_hi ||
            !arr_npk || !arr_th || (mesh_off && (!arr_src || !arr_dst))) {
          Py_XDECREF(rows_l); Py_XDECREF(src_l); Py_XDECREF(keys_l);
          Py_XDECREF(arr_t); Py_XDECREF(arr_lo); Py_XDECREF(arr_hi);
          Py_XDECREF(arr_npk); Py_XDECREF(arr_th);
          Py_XDECREF(arr_src); Py_XDECREF(arr_dst);
          goto done;
        }
        int64_t *pt = PyArray_DATA((PyArrayObject *)arr_t);
        uint32_t *plo = PyArray_DATA((PyArrayObject *)arr_lo);
        uint32_t *phi = PyArray_DATA((PyArrayObject *)arr_hi);
        uint32_t *pnp = PyArray_DATA((PyArrayObject *)arr_npk);
        uint32_t *pth = PyArray_DATA((PyArrayObject *)arr_th);
        int32_t *psrc = mesh_off
            ? PyArray_DATA((PyArrayObject *)arr_src) : NULL;
        int32_t *pdst = mesh_off
            ? PyArray_DATA((PyArrayObject *)arr_dst) : NULL;
        int fail = 0;
        for (int i = 0; i < keep && !fail; i++) {
          BRow *b = &c->brow[i];
          /* egress-format tuple for the Python device/mesh machinery
           * (amortized by the batch's >= device_floor size) */
          PyObject *row_t = Py_BuildValue(
              "(iiLLiiLLiiO)", (int)b->kind, (int)b->dst,
              (long long)b->size, (long long)b->t_emit, (int)b->sport,
              (int)b->dport, (long long)b->nbytes, (long long)b->seq,
              (int)b->frag, (int)b->nfrags,
              b->payload ? b->payload : Py_None);
          if (!row_t) { fail = 1; break; }
          PyList_SET_ITEM(rows_l, i, row_t);
          Py_INCREF(b->src_obj);
          PyList_SET_ITEM(src_l, i, b->src_obj);
          PyObject *kv = PyLong_FromLongLong(b->key);
          if (!kv) { fail = 1; break; }
          PyList_SET_ITEM(keys_l, i, kv);
          pt[i] = b->arrival;
          plo[i] = (uint32_t)(b->uid & 0xFFFFFFFFu);
          phi[i] = (uint32_t)(b->uid >> 32);
          pnp[i] = (uint32_t)b->npk;
          pth[i] = b->th;
          if (mesh_off) {
            psrc[i] = b->src;
            pdst[i] = b->dst;
          }
        }
        if (fail) {
          Py_DECREF(rows_l); Py_DECREF(src_l); Py_DECREF(keys_l);
          Py_DECREF(arr_t); Py_DECREF(arr_lo); Py_DECREF(arr_hi);
          Py_DECREF(arr_npk); Py_DECREF(arr_th);
          Py_XDECREF(arr_src); Py_XDECREF(arr_dst);
          goto done;
        }
        if (mesh_off)
          result = Py_BuildValue("(NNNNNNNNNN)", rows_l, src_l, arr_t,
                                 keys_l, arr_lo, arr_hi, arr_npk, arr_th,
                                 arr_src, arr_dst);
        else
          result = Py_BuildValue("(NNNNNNNN)", rows_l, src_l, arr_t,
                                 keys_l, arr_lo, arr_hi, arr_npk, arr_th);
        if (!result) goto done;
        goto done; /* row refs now held by rows_l */
      }
    }
  }

  /* inline loss draws (threefry) + store; with speculation on, a live
   * unit first consults its host's speculative window (verified (npk,
   * th) class + uid range — bit-identical by construction) and only
   * draws inline on a miss */
  if (any_live) {
    for (int i = 0; i < keep; i++) {
      BRow *b = &c->brow[i];
      if (!b->th) {
        b->drop = 0;
        continue;
      }
      int sv = c->spec_on ? spec_consult(c, b) : -1;
      if (sv >= 0) {
        b->drop = (uint8_t)sv;
        c->spec_hits++;
      } else {
        b->drop = (uint8_t)unit_dropped(c->seed, b->uid, b->npk, b->th);
        c->spec_draws += c->spec_on;
      }
    }
  }
  if (store_build(c, c->brow, keep, any_live, round_end) < 0) goto done;
  result = Py_True;
  Py_INCREF(Py_True);

done:
  for (int i = 0; i < nown; i++) Py_XDECREF(c->brow[i].payload);
  free(ems);
  Py_DECREF(emitters);
  return result;
}

/* ---- extraction (colplane._extract twin) ------------------------------ */
static int cmp_irow(const void *a, const void *b) {
  const IRow *x = a, *y = b;
  if (x->t != y->t) return (x->t > y->t) - (x->t < y->t);
  return (x->key > y->key) - (x->key < y->key);
}

static int inbox_grow(CHost *h) {
  int ncap = h->inbox_cap ? h->inbox_cap * 2 : 32;
  IRow *nb = realloc(h->inbox, sizeof(IRow) * (size_t)ncap);
  if (!nb) { PyErr_NoMemory(); return -1; }
  h->inbox = nb;
  h->inbox_cap = ncap;
  return 0;
}

static inline void inbox_slice_mark(CHost *h, int slice) {
  if (h->inbox_n == 0) {
    h->inbox_last_slice = slice;
    h->inbox_multi = 0;
  } else if (h->inbox_last_slice != slice) {
    h->inbox_multi = 1;
    h->inbox_last_slice = slice;
  }
}

/* all fields come from the packed record; payload ref is INCREF'd into
 * the IRow (released by run_host's inbox-free loop) */
static int inbox_push_rec(CHost *h, const SRec *s, PyObject *payload,
                          int slice) {
  if (h->inbox_n == h->inbox_cap && inbox_grow(h) < 0) return -1;
  inbox_slice_mark(h, slice);
  IRow *r = &h->inbox[h->inbox_n++];
  r->t = s->t;
  r->key = s->key;
  Py_XINCREF(payload);
  r->payload = payload;
  r->kind = s->kind;
  r->peer = s->peer;
  r->bport = s->bport;
  r->aport = s->aport;
  r->nbytes = s->nbytes;
  r->seq = s->seq;
  r->frag = s->frag;
  r->nfrags = s->nfrags;
  r->size = s->size;
  return 0;
}

/* the colplane 13-tuple for one inbox row (Python-fallback dispatch and
 * deferred parking; tgt is the owning host) */
static PyObject *irow_tuple(const CHost *h, const IRow *r, int64_t tgt) {
  SRec s;
  (void)h;
  s.t = r->t; s.key = r->key; s.tgt = (int32_t)tgt; s.size = r->size;
  s.peer = r->peer; s.bport = r->bport; s.aport = r->aport;
  s.nbytes = r->nbytes; s.seq = r->seq; s.kind = r->kind;
  s.frag = r->frag; s.nfrags = r->nfrags;
  return srec_tuple(&s, r->payload);
}

static PyObject *Core_refill_ingress(CoreObject *c, PyObject *args) {
  /* start_of_round ingress refill (fluid.clamped_refill twin): tokens
   * gain min(bytes_over(rate, dt), cap) clamped at cap — pure int64,
   * one pass, no per-round numpy temporaries */
  long long dt_ll;
  if (!PyArg_ParseTuple(args, "L", &dt_ll)) return NULL;
  int64_t dt = dt_ll;
  int64_t q = dt / NS_PER_SEC, r = dt % NS_PER_SEC;
  for (int64_t i = 0; i < c->H; i++) {
    int64_t rate = c->rate_down[i], cap = c->cap_down[i];
    int64_t add = rate * q +
                  (int64_t)((uint64_t)rate * (uint64_t)r /
                            (uint64_t)NS_PER_SEC);
    if (add > cap) add = cap;
    int64_t room = cap - c->tokens_down[i];
    c->tokens_down[i] += add < room ? add : room;
  }
  Py_RETURN_NONE;
}

static PyObject *Core_extract(CoreObject *c, PyObject *args) {
  long long re_ll;
  if (!PyArg_ParseTuple(args, "L", &re_ll)) return NULL;
  int64_t round_end = re_ll;
  /* touched-host tracking for activation + sorting */
  int64_t *touched = NULL;
  int ntouched = 0, captouched = 0;
  int nslices = 0;
  PyObject *it = PyObject_GetIter(c->pending);
  if (!it) return NULL;
  PyObject *batch;
  while ((batch = PyIter_Next(it))) {
    if (Py_TYPE(batch) != &CBatch_Type) {
      PyErr_SetString(PyExc_TypeError,
                      "C extract expects CBatch store batches only");
      Py_DECREF(batch);
      goto fail;
    }
    CBatch *cb = (CBatch *)batch;
    SRec *recs = cb->recs;
    int pos = cb->pos, ln = cb->n;
    if (pos >= ln || recs[pos].t >= round_end) {
      Py_DECREF(batch);
      continue;
    }
    /* bisect_left by row time for round_end */
    int lo = pos, hi = ln;
    while (lo < hi) {
      int mid = (lo + hi) / 2;
      if (recs[mid].t < round_end) lo = mid + 1;
      else hi = mid;
    }
    for (int i = pos; i < lo; i++) {
      int64_t tgt = recs[i].tgt;
      if (tgt < 0 || tgt >= c->H) {
        if (!PyErr_Occurred())
          PyErr_SetString(PyExc_ValueError, "row target out of range");
        Py_DECREF(batch); goto fail;
      }
      CHost *h = &c->hs[tgt];
      if (h->inbox_n == 0) {
        if (ntouched == captouched) {
          captouched = captouched ? captouched * 2 : 64;
          int64_t *nt = realloc(touched,
                                sizeof(int64_t) * (size_t)captouched);
          if (!nt) {
            PyErr_NoMemory();
            Py_DECREF(batch); goto fail;
          }
          touched = nt;
        }
        touched[ntouched++] = tgt;
      }
      if (inbox_push_rec(h, &recs[i], cb->pay[i], nslices) < 0) {
        Py_DECREF(batch); goto fail;
      }
    }
    cb->pos = lo;
    nslices++;
    Py_DECREF(batch);
  }
  Py_DECREF(it);
  it = NULL;
  if (PyErr_Occurred()) goto fail;
  /* pop fully consumed batches off the front of the deque */
  for (;;) {
    Py_ssize_t np = PySequence_Size(c->pending);
    if (np < 0) goto fail;
    if (np == 0) break;
    PyObject *first = PySequence_GetItem(c->pending, 0);
    if (!first) goto fail;
    int done_b = Py_TYPE(first) == &CBatch_Type &&
                 ((CBatch *)first)->pos >= ((CBatch *)first)->n;
    Py_DECREF(first);
    if (!done_b) break;
    PyObject *r = PyObject_CallMethodObjArgs(c->pending, S_popleft, NULL);
    if (!r) goto fail;
    Py_DECREF(r);
  }
  if (ntouched == 0) {
    free(touched);
    Py_RETURN_NONE;
  }
  int multi = nslices > 1;
  for (int i = 0; i < ntouched; i++) {
    CHost *h = &c->hs[touched[i]];
    if (multi && h->inbox_n > 1 && h->inbox_multi)
      qsort(h->inbox, (size_t)h->inbox_n, sizeof(IRow), cmp_irow);
    if (h->py_mode) { /* (see below for the active-set add) */
      /* pcap hosts: hand a plain Python list of 13-tuples to
       * Host.run_events (materialized here; py_mode hosts are rare) */
      PyObject *lst = PyList_New(h->inbox_n);
      if (!lst) goto fail;
      for (int j = 0; j < h->inbox_n; j++) {
        PyObject *t = irow_tuple(h, &h->inbox[j], touched[i]);
        if (!t) { Py_DECREF(lst); goto fail; }
        PyList_SET_ITEM(lst, j, t);
        Py_XDECREF(h->inbox[j].payload);
        h->inbox[j].payload = NULL; /* cleanup passes must not re-release */
      }
      h->inbox_n = 0;
      int r = PyObject_SetAttr(h->host, S_inbox, lst);
      Py_DECREF(lst);
      if (r < 0) goto fail;
    }
    /* activate, recording genuinely-new members for the merge refresh */
    {
      int has = PySet_Contains(c->active, h->id_obj);
      if (has < 0) goto fail;
      if (!has) {
        if (PySet_Add(c->active, h->id_obj) < 0) goto fail;
        if (act_pend_add(c, touched[i]) < 0) goto fail;
      }
    }
  }
  free(touched);
  Py_RETURN_NONE;
fail:
  Py_XDECREF(it);
  free(touched);
  return NULL;
}

/* ---- GossipState type -------------------------------------------------- */
static int Gossip_traverse(GossipState *g, visitproc visit, void *arg) {
  Py_VISIT(g->core);
  return 0;
}

static int Gossip_clear_gc(GossipState *g) {
  Py_CLEAR(g->core);
  return 0;
}

static void Gossip_dealloc(GossipState *g) {
  PyObject_GC_UnTrack(g);
  Py_XDECREF(g->core);
  Py_XDECREF(g->port_obj);
  free(g->peers);
  seen_free(&g->seen);
  Py_TYPE(g)->tp_free((PyObject *)g);
}

static PyObject *Gossip_originate(GossipState *g, PyObject *arg) {
  char *buf;
  Py_ssize_t n;
  if (PyBytes_AsStringAndSize(arg, &buf, &n) < 0) return NULL;
  if (seen_add(&g->seen, buf, n) < 0) return PyErr_NoMemory();
  CoreObject *c = g->core;
  CHost *h = &c->hs[g->hid];
  int64_t now;
  if (attr_i64(h->host, S_now, &now) < 0) return NULL;
  if (gossip_announce(c, h, g, now, buf, n, -1) < 0) return NULL;
  Py_RETURN_NONE;
}

/* fallback entry (deferred-ingress drains, fragmented datagrams): the
 * Python GossipNode._on_msg delegates here with (payload, src_host, now) */
static PyObject *Gossip_on_msg(GossipState *g, PyObject *args) {
  PyObject *payload;
  long long src_host, now;
  if (!PyArg_ParseTuple(args, "OLL", &payload, &src_host, &now)) return NULL;
  CoreObject *c = g->core;
  CHost *h = &c->hs[g->hid];
  if (gossip_on_msg_c(c, h, g, now, payload, src_host) < 0) return NULL;
  Py_RETURN_NONE;
}

static PyObject *Gossip_stats(GossipState *g, PyObject *noarg) {
  (void)noarg;
  return Py_BuildValue("(Ln)", (long long)g->received_tx,
                       (Py_ssize_t)g->seen.count);
}

static PyObject *Gossip_export_state(GossipState *g, PyObject *noarg);
static PyObject *Gossip_restore_state(GossipState *g, PyObject *state);

static PyMethodDef Gossip_methods[] = {
    {"originate", (PyCFunction)Gossip_originate, METH_O,
     "record a locally-originated txid and announce it to all peers"},
    {"on_msg", (PyCFunction)Gossip_on_msg, METH_VARARGS,
     "Python-fallback message delivery: (payload, src_host, now)"},
    {"stats", (PyCFunction)Gossip_stats, METH_NOARGS,
     "-> (received_tx, seen_count)"},
    {"_export_state", (PyCFunction)Gossip_export_state, METH_NOARGS,
     "checkpoint export: (hid, port, peers, seen, received, next_dgram)"},
    {"_restore_state", (PyCFunction)Gossip_restore_state, METH_O,
     "checkpoint restore (core binding comes via Core.adopt)"},
    {NULL, NULL, 0, NULL}};

static PyTypeObject GossipState_Type = {
    PyVarObject_HEAD_INIT(NULL, 0).tp_name = "_colcore.GossipState",
    .tp_basicsize = sizeof(GossipState),
    .tp_dealloc = (destructor)Gossip_dealloc,
    .tp_flags = Py_TPFLAGS_DEFAULT | Py_TPFLAGS_HAVE_GC,
    .tp_traverse = (traverseproc)Gossip_traverse,
    .tp_clear = (inquiry)Gossip_clear_gc,
    .tp_methods = Gossip_methods,
    .tp_free = PyObject_GC_Del,
    .tp_doc = "C half of the gossip model (models/gossip.py delegates)",
};

/* ---- Core type --------------------------------------------------------- */

/* fetch a numpy array attr, validate dtype/contiguity, return new ref and
 * set *data */
static PyObject *grab_array(PyObject *o, const char *name, int typenum,
                            void **data) {
  PyObject *v = PyObject_GetAttrString(o, name);
  if (!v) return NULL;
  if (!PyArray_Check(v) ||
      PyArray_TYPE((PyArrayObject *)v) != typenum ||
      !PyArray_IS_C_CONTIGUOUS((PyArrayObject *)v)) {
    PyErr_Format(PyExc_TypeError,
                 "%s must be a C-contiguous numpy array of the expected "
                 "dtype", name);
    Py_DECREF(v);
    return NULL;
  }
  *data = PyArray_DATA((PyArrayObject *)v);
  return v;
}

static int Core_traverse(CoreObject *c, visitproc visit, void *arg) {
  Py_VISIT(c->hosts);
  Py_VISIT(c->pending);
  Py_VISIT(c->deferred);
  Py_VISIT(c->active);
  Py_VISIT(c->storebatch_cls);
  Py_VISIT(c->xout);
  for (int i = 0; i < 11; i++) Py_VISIT(c->arrs[i]);
  if (c->hs) {
    for (int64_t i = 0; i < c->H; i++) {
      CHost *h = &c->hs[i];
      Py_VISIT(h->id_obj);
      Py_VISIT(h->equeue);
      Py_VISIT(h->heap);
      Py_VISIT(h->live);
      Py_VISIT(h->cancelled);
      Py_VISIT(h->head_cache);
      Py_VISIT(h->egress);
      Py_VISIT(h->conns);
      Py_VISIT(h->listeners);
      Py_VISIT(h->ack_eps);
      for (int j = 0; j < h->nports; j++) Py_VISIT(h->gs[j]);
      /* inbox payloads / egress payloads are bytes|None (no cycles) */
    }
  }
  return 0;
}

static int Core_clear_gc(CoreObject *c) {
  Py_CLEAR(c->hosts);
  Py_CLEAR(c->pending);
  Py_CLEAR(c->deferred);
  Py_CLEAR(c->active);
  Py_CLEAR(c->storebatch_cls);
  Py_CLEAR(c->xout);
  for (int i = 0; i < 11; i++) Py_CLEAR(c->arrs[i]);
  if (c->hs) {
    for (int64_t i = 0; i < c->H; i++) {
      CHost *h = &c->hs[i];
      Py_CLEAR(h->id_obj);
      Py_CLEAR(h->equeue);
      Py_CLEAR(h->heap);
      Py_CLEAR(h->live);
      Py_CLEAR(h->cancelled);
      Py_CLEAR(h->head_cache);
      Py_CLEAR(h->egress);
      Py_CLEAR(h->conns);
      Py_CLEAR(h->listeners);
      Py_CLEAR(h->ack_eps);
      for (int j = 0; j < h->nports; j++) Py_CLEAR(h->gs[j]);
      h->nports = 0;
      for (int j = 0; j < h->inbox_n; j++) Py_CLEAR(h->inbox[j].payload);
      h->inbox_n = 0;
      for (int j = 0; j < h->erow_n; j++) Py_CLEAR(h->erow[j].payload);
      h->erow_n = 0;
    }
  }
  return 0;
}

static void Core_dealloc(CoreObject *c) {
  PyObject_GC_UnTrack(c);
  if (c->hs) {
    for (int64_t i = 0; i < c->H; i++) {
      CHost *h = &c->hs[i];
      Py_XDECREF(h->id_obj);
      Py_XDECREF(h->equeue);
      Py_XDECREF(h->heap);
      Py_XDECREF(h->live);
      Py_XDECREF(h->cancelled);
      Py_XDECREF(h->head_cache);
      Py_XDECREF(h->egress);
      Py_XDECREF(h->conns);
      Py_XDECREF(h->listeners);
      Py_XDECREF(h->ack_eps);
      for (int j = 0; j < h->inbox_n; j++) Py_XDECREF(h->inbox[j].payload);
      free(h->inbox);
      for (int j = 0; j < h->erow_n; j++) Py_XDECREF(h->erow[j].payload);
      free(h->erow);
      for (int j = 0; j < h->nports; j++) Py_XDECREF(h->gs[j]);
    }
    free(c->hs);
  }
  free(c->brow);
  free(c->act_ids);
  free(c->act_pend);
  if (c->spec) {
    for (int64_t i = 0; i < c->H; i++) {
      free(c->spec[i].min_a);
      free(c->spec[i].min_b);
      free(c->spec[i].nmin_a);
      free(c->spec[i].nmin_b);
    }
    free(c->spec);
  }
  free(c->spec_dq);
  if (c->xrecs) {
    for (int j = 0; j < c->shard_n; j++) {
      for (int i = 0; i < c->xn[j]; i++) Py_XDECREF(c->xpay[j][i]);
      free(c->xrecs[j]);
      free(c->xpay[j]);
    }
    free(c->xrecs);
    free(c->xpay);
    free(c->xn);
    free(c->xcap);
  }
  Py_XDECREF(c->hosts);
  Py_XDECREF(c->pending);
  Py_XDECREF(c->deferred);
  Py_XDECREF(c->active);
  Py_XDECREF(c->storebatch_cls);
  Py_XDECREF(c->xout);
  for (int i = 0; i < 11; i++) Py_XDECREF(c->arrs[i]);
  Py_TYPE(c)->tp_free((PyObject *)c);
}

static int Core_init(CoreObject *c, PyObject *args, PyObject *kwds) {
  (void)kwds;
  PyObject *plane;
  if (!PyArg_ParseTuple(args, "O", &plane)) return -1;
  /* plane._c will own us; we keep a borrowed back-pointer (the plane
   * outlives the core by construction — documented cycle break) */
  c->plane = plane;
  c->hosts = PyObject_GetAttrString(plane, "hosts");
  if (!c->hosts) return -1;
  if (PyList_Check(c->hosts)) {
    c->H = PyList_GET_SIZE(c->hosts);
  } else {
    Py_ssize_t hn = PySequence_Size(c->hosts);
    if (hn < 0) return -1;
    PyObject *asl = PySequence_List(c->hosts);
    if (!asl) return -1;
    Py_SETREF(c->hosts, asl);
    c->H = hn;
  }
  c->pending = PyObject_GetAttrString(plane, "pending");
  if (!c->pending) return -1;
  c->deferred = PyObject_GetAttrString(plane, "_deferred");
  if (!c->deferred) return -1;
  PyObject *params = PyObject_GetAttrString(plane, "params");
  if (!params) return -1;
  PyObject *buckets = PyObject_GetAttrString(plane, "buckets");
  PyObject *graph = PyObject_GetAttrString(plane, "graph");
  int ok = params && buckets && graph;
  if (ok) {
    void *p;
    ok = (c->arrs[0] = grab_array(plane, "tokens_down", NPY_INT64, &p)) != 0;
    c->tokens_down = p;
    if (ok) { c->arrs[1] = grab_array(buckets, "t_base", NPY_INT64, &p);
              c->tbase = p; ok = c->arrs[1] != 0; }
    if (ok) { c->arrs[2] = grab_array(buckets, "tokens", NPY_INT64, &p);
              c->tokens = p; ok = c->arrs[2] != 0; }
    if (ok) { c->arrs[3] = grab_array(buckets, "debt", NPY_INT64, &p);
              c->debt = p; ok = c->arrs[3] != 0; }
    if (ok) { c->arrs[4] = grab_array(params, "rate_up", NPY_INT64, &p);
              c->rate_up = p; ok = c->arrs[4] != 0; }
    if (ok) { c->arrs[5] = grab_array(params, "cap_up", NPY_INT64, &p);
              c->cap_up = p; ok = c->arrs[5] != 0; }
    if (ok) { c->arrs[6] = grab_array(graph, "latency_ns", NPY_INT64, &p);
              c->lat = p; ok = c->arrs[6] != 0; }
    if (ok) { c->arrs[7] = grab_array(params, "drop_thresh", NPY_UINT32, &p);
              c->thresh = p; ok = c->arrs[7] != 0; }
    if (ok) { c->arrs[8] = grab_array(params, "host_node", NPY_INT32, &p);
              c->hostnode = p; ok = c->arrs[8] != 0; }
    if (ok) { c->arrs[9] = grab_array(params, "rate_down", NPY_INT64, &p);
              c->rate_down = p; ok = c->arrs[9] != 0; }
    if (ok) { c->arrs[10] = grab_array(params, "cap_down", NPY_INT64, &p);
              c->cap_down = p; ok = c->arrs[10] != 0; }
    if (ok) {
      c->G = PyArray_DIM((PyArrayObject *)c->arrs[6], 0);
      int64_t seed;
      ok = attr_i64(params, S_seed, &seed) == 0;
      c->seed = (uint64_t)seed;
    }
  }
  Py_XDECREF(params);
  Py_XDECREF(buckets);
  Py_XDECREF(graph);
  if (!ok) return -1;
  if (attr_i64(plane, S_bootstrap_end, &c->bootstrap_end) < 0)
    return -1;
  PyObject *mp = PyObject_GetAttrString(plane, "mesh_plane");
  if (!mp) return -1;
  c->mesh_mode = mp != Py_None;
  Py_DECREF(mp);
  PyObject *fa = PyObject_GetAttrString(plane, "faults_active");
  if (!fa) return -1;
  c->faults_active = PyObject_IsTrue(fa);
  Py_DECREF(fa);
  if (c->faults_active < 0) return -1;
  c->unit_chunk = 0; /* filled from hosts[0] below (config-uniform) */
  PyObject *mod = PyImport_ImportModule("shadow_tpu_torch.network.colplane");
  if (!mod) return -1;
  c->storebatch_cls = PyObject_GetAttrString(mod, "StoreBatch");
  Py_DECREF(mod);
  if (!c->storebatch_cls) return -1;
  c->hs = calloc((size_t)c->H, sizeof(CHost));
  if (!c->hs) { PyErr_NoMemory(); return -1; }
  for (int64_t i = 0; i < c->H; i++) {
    CHost *h = &c->hs[i];
    PyObject *host = PyList_GET_ITEM(c->hosts, i);
    h->host = host;
    h->id_obj = PyObject_GetAttr(host, S_id);
    if (!h->id_obj) return -1;
    if (PyLong_AsLongLong(h->id_obj) != i) {
      PyErr_SetString(PyExc_ValueError, "hosts list not id-ordered");
      return -1;
    }
    PyObject *eq = PyObject_GetAttrString(host, "equeue");
    if (!eq) return -1;
    h->equeue = eq; /* owned */
    h->heap = PyObject_GetAttrString(eq, "_heap");
    h->live = PyObject_GetAttrString(eq, "_live");
    h->cancelled = PyObject_GetAttrString(eq, "_cancelled");
    if (!h->heap || !h->live || !h->cancelled) return -1;
    PyObject *pcap = PyObject_GetAttr(host, S_pcap);
    if (!pcap) return -1;
    h->py_mode = pcap != Py_None;
    Py_DECREF(pcap);
    /* crashed-host flag: nonzero when the core is (re)built over a
     * restored simulation whose checkpoint caught a host mid-downtime */
    PyObject *dv = PyObject_GetAttr(host, S_down);
    if (!dv) return -1;
    h->down = PyObject_IsTrue(dv);
    Py_DECREF(dv);
    if (h->down < 0) return -1;
    h->egress = PyObject_GetAttr(host, S_egress_rows);
    if (!h->egress) return -1;
    if (!PyList_Check(h->egress)) {
      PyErr_SetString(PyExc_TypeError, "host.egress_rows must be a list");
      return -1;
    }
    h->conns = PyObject_GetAttrString(host, "_conns");
    h->listeners = PyObject_GetAttrString(host, "_listeners");
    h->ack_eps = PyObject_GetAttrString(host, "_ack_eps");
    if (!h->conns || !h->listeners || !h->ack_eps) return -1;
    {
      int64_t cc;
      if (attr_i64(host, S_cc_id, &cc) < 0)
        return -1;
      h->cc_kind = (int)cc;
    }
    if (!PyDict_Check(h->ack_eps)) {
      PyErr_SetString(PyExc_TypeError, "host._ack_eps must be a dict");
      return -1;
    }
    if (i == 0) {
      int64_t uc;
      if (attr_i64(host, S_unit_chunk, &uc) < 0)
        return -1;
      c->unit_chunk = uc;
      PyObject *exp = NULL, *ctl2 = PyObject_GetAttrString(host,
                                                           "controller");
      PyObject *cfg2 = ctl2 ? PyObject_GetAttrString(ctl2, "cfg") : NULL;
      exp = cfg2 ? PyObject_GetAttrString(cfg2, "experimental") : NULL;
      int ok2 = exp &&
          attr_i64(exp, S_socket_send_buffer, &c->sock_sbuf) == 0 &&
          attr_i64(exp, S_socket_recv_buffer, &c->sock_rbuf) == 0;
      Py_XDECREF(exp);
      Py_XDECREF(cfg2);
      Py_XDECREF(ctl2);
      if (!ok2) return -1;
    }
  }
  return 0;
}

static PyObject *Core_bind_active(CoreObject *c, PyObject *arg) {
  if (!PySet_Check(arg)) {
    PyErr_SetString(PyExc_TypeError, "bind_active expects the active set");
    return NULL;
  }
  Py_INCREF(arg);
  Py_XSETREF(c->active, arg);
  c->act_n = -1; /* invalidate the sorted snapshot cache */
  c->act_pend_n = 0;
  Py_RETURN_NONE;
}

/* the activation hook (controller wires equeue.on_first and
 * plane.activate here when the C engine is attached): set-add + pend
 * record, so the next refresh merges instead of re-snapshotting */
static PyObject *Core_activate(CoreObject *c, PyObject *arg) {
  if (!c->active) {
    PyErr_SetString(PyExc_RuntimeError, "bind_active() not called");
    return NULL;
  }
  int has = PySet_Contains(c->active, arg);
  if (has < 0) return NULL;
  if (!has) {
    int64_t hid = PyLong_AsLongLong(arg);
    if (hid == -1 && PyErr_Occurred()) return NULL;
    if (PySet_Add(c->active, arg) < 0) return NULL;
    if (act_pend_add(c, hid) < 0) return NULL;
  }
  Py_RETURN_NONE;
}

static PyObject *Core_gossip_register(CoreObject *c, PyObject *args) {
  long long hid, port;
  PyObject *peers;
  if (!PyArg_ParseTuple(args, "LLO", &hid, &port, &peers)) return NULL;
  if (hid < 0 || hid >= c->H) {
    PyErr_SetString(PyExc_ValueError, "host id out of range");
    return NULL;
  }
  CHost *h = &c->hs[hid];
  if (h->nports >= 4) {
    PyErr_SetString(PyExc_ValueError, "too many C ports on one host");
    return NULL;
  }
  PyObject *pl = PySequence_List(peers);
  if (!pl) return NULL;
  Py_ssize_t np = PyList_GET_SIZE(pl);
  GossipState *g = PyObject_GC_New(GossipState, &GossipState_Type);
  if (!g) { Py_DECREF(pl); return NULL; }
  Py_INCREF(c);
  g->core = c;
  g->hid = (int)hid;
  g->port = (int)port;
  g->port_obj = PyLong_FromLongLong(port);
  g->peers = malloc(sizeof(int32_t) * (size_t)(np ? np : 1));
  g->npeers = (int)np;
  g->received_tx = 0;
  g->next_dgram = 0;
  memset(&g->seen, 0, sizeof g->seen);
  if (!g->port_obj || !g->peers || seen_init(&g->seen) < 0) {
    Py_DECREF(pl);
    Py_DECREF(g);
    return PyErr_NoMemory();
  }
  for (Py_ssize_t i = 0; i < np; i++)
    g->peers[i] = (int32_t)PyLong_AsLongLong(PyList_GET_ITEM(pl, i));
  Py_DECREF(pl);
  if (PyErr_Occurred()) { Py_DECREF(g); return NULL; }
  h->port[h->nports] = (int)port;
  Py_INCREF(g);
  h->gs[h->nports] = g;
  h->nports++;
  PyObject_GC_Track((PyObject *)g);
  return (PyObject *)g;
}

static PyObject *Core_fold_counters(CoreObject *c, PyObject *noarg) {
  (void)noarg;
  for (int64_t i = 0; i < c->H; i++) {
    CHost *h = &c->hs[i];
    if (attr_add_i64(h->host, S_n_emitted, h->d_emitted) < 0 ||
        attr_add_i64(h->host, S_n_delivered, h->d_delivered) < 0 ||
        attr_add_i64(h->host, S_n_dgrams, h->d_dgrams) < 0 ||
        attr_add_i64(h->host, S_n_dgrams_recv, h->d_dgrams_recv) < 0 ||
        attr_add_i64(h->host, S_n_events, h->d_events) < 0 ||
        attr_add_i64(h->host, S_n_teardown, h->d_teardown) < 0 ||
        attr_add_i64(h->host, S_n_blackholed, h->d_blackholed) < 0)
      return NULL;
    h->d_emitted = h->d_delivered = h->d_dgrams = h->d_dgrams_recv = 0;
    h->d_events = 0;
    h->d_teardown = h->d_blackholed = 0;
    /* stream/routing counters go through host.counters.add (key space
     * shared with the Python transport; the last four are the
     * faults_active-gated recovery counters — the deltas are only ever
     * incremented with faults on, so the fold stays unconditional) */
    static const char *names2[8] = {"stream_bytes_queued",
                                    "stream_bytes_received",
                                    "stream_resets", "units_unroutable",
                                    "stream_fast_retransmits",
                                    "stream_rto_retransmits",
                                    "stream_timeouts",
                                    "stream_sack_retransmits"};
    int64_t *vals[8] = {&h->d_sbytes_q, &h->d_sbytes_recv, &h->d_resets,
                        &h->d_unroutable, &h->d_fast_retx,
                        &h->d_rto_retx, &h->d_timeouts, &h->d_sack_retx};
    PyObject *ctrs = NULL;
    for (int j = 0; j < 8; j++) {
      if (!*vals[j]) continue;
      if (!ctrs) {
        ctrs = PyObject_GetAttrString(h->host, "counters");
        if (!ctrs) return NULL;
      }
      PyObject *r = PyObject_CallMethod(ctrs, "add", "(sL)", names2[j],
                                        (long long)*vals[j]);
      if (!r) { Py_DECREF(ctrs); return NULL; }
      Py_DECREF(r);
      *vals[j] = 0;
    }
    Py_XDECREF(ctrs);
  }
  Py_RETURN_NONE;
}

static PyObject *Core_make_endpoint(CoreObject *c, PyObject *args);
static PyObject *Core_flush_acks(CoreObject *c, PyObject *arg);
static PyObject *Core_run_round(CoreObject *c, PyObject *args);
static PyObject *Core_relay_new(CoreObject *c, PyObject *args);
static PyObject *Core_tor_client_sink(CoreObject *c, PyObject *args);
static PyObject *Core_adopt(CoreObject *c, PyObject *arg);

/* -- fault lifecycle (shadow_tpu/faults.py) ------------------------------ */
static PyObject *Core_bind_shard(CoreObject *c, PyObject *args) {
  /* multi-process sharding: (shard_id, n_shards, xout) where xout is the
   * plane's list of n_shards per-destination-shard row lists — or None,
   * which selects the PACKED send path: diverted rows accumulate in the
   * core's SRec buffers and drain as wire-format blocks via
   * take_xout_packed (no per-row Python tuples). Rebinding (e.g. after
   * take_xout swaps fresh lists in) is the normal pattern. */
  int sid, n;
  PyObject *xout;
  if (!PyArg_ParseTuple(args, "iiO", &sid, &n, &xout)) return NULL;
  if (n < 1 || sid < 0 || sid >= n) {
    PyErr_SetString(PyExc_ValueError, "bind_shard: shard_id/n out of range");
    return NULL;
  }
  if (xout == Py_None) {
    if (!c->xrecs || c->shard_n != n) {
      if (c->xrecs) { /* shard count changed: drop the old buffers */
        for (int j = 0; j < c->shard_n; j++) {
          for (int i = 0; i < c->xn[j]; i++) Py_XDECREF(c->xpay[j][i]);
          free(c->xrecs[j]);
          free(c->xpay[j]);
        }
        free(c->xrecs); free(c->xpay); free(c->xn); free(c->xcap);
      }
      c->xrecs = calloc((size_t)n, sizeof(SRec *));
      c->xpay = calloc((size_t)n, sizeof(PyObject **));
      c->xn = calloc((size_t)n, sizeof(int));
      c->xcap = calloc((size_t)n, sizeof(int));
      if (!c->xrecs || !c->xpay || !c->xn || !c->xcap) {
        free(c->xrecs); free(c->xpay); free(c->xn); free(c->xcap);
        c->xrecs = NULL; c->xpay = NULL; c->xn = NULL; c->xcap = NULL;
        return PyErr_NoMemory();
      }
    }
    c->xpacked = 1;
    c->shard_id = sid;
    c->shard_n = n;
    Py_CLEAR(c->xout);
    Py_RETURN_NONE;
  }
  if (!PyList_Check(xout) || PyList_GET_SIZE(xout) != n) {
    PyErr_SetString(PyExc_TypeError,
                    "bind_shard expects xout as a list of n_shards lists "
                    "or None (packed mode)");
    return NULL;
  }
  c->xpacked = 0;
  c->shard_id = sid;
  c->shard_n = n;
  Py_INCREF(xout);
  Py_XSETREF(c->xout, xout);
  Py_RETURN_NONE;
}

/* drain the packed cross-shard egress buffers (bind_shard(.., None)
 * mode) as a list of per-destination-shard lists of wire-format byte
 * blocks — the exact parallel/shards.py pack_rows layout
 * ([n u64][numeric cols (n,12) i64][payload lens i64][blobs], rows
 * (t,key)-sorted, marshal payloads with negative-length pickle
 * fallback), chunked so no block exceeds max_bytes (a single giant row
 * still forms one block; the worker's ring-capacity guard names it).
 * This closes the send-side half of the packed wire path: the receiver
 * already parses these bytes straight into a CBatch
 * (cbatch_from_packed), and now the sender never materializes 13-field
 * Python tuples either. */
static PyObject *Core_take_xout_packed(CoreObject *c, PyObject *args) {
  long long max_bytes;
  if (!PyArg_ParseTuple(args, "L", &max_bytes)) return NULL;
  if (!c->xpacked || !c->xrecs) {
    PyErr_SetString(PyExc_RuntimeError,
                    "take_xout_packed: packed mode not bound "
                    "(bind_shard(sid, n, None) first)");
    return NULL;
  }
  if (max_bytes < 4096) max_bytes = 4096;
  PyObject *outer = PyList_New(c->shard_n);
  if (!outer) return NULL;
  for (int j = 0; j < c->shard_n; j++) {
    PyObject *blocks = PyList_New(0);
    if (!blocks) { Py_DECREF(outer); return NULL; }
    PyList_SET_ITEM(outer, j, blocks);
  }
  for (int j = 0; j < c->shard_n; j++) {
    int n = c->xn[j];
    if (!n) continue;
    PyObject *blocks = PyList_GET_ITEM(outer, j);
    SRec *recs = c->xrecs[j];
    PyObject **pay = c->xpay[j];
    ORow *ord = malloc(sizeof(ORow) * (size_t)n);
    PyObject **blobs = calloc((size_t)n, sizeof(PyObject *));
    int64_t *lens = malloc(sizeof(int64_t) * (size_t)n);
    int fail = !ord || !blobs || !lens;
    if (!fail) {
      for (int i = 0; i < n; i++) {
        ord[i].t = recs[i].t;
        ord[i].key = recs[i].key;
        ord[i].idx = i;
      }
      qsort(ord, (size_t)n, sizeof(ORow), cmp_orow);
      /* serialize payloads in sorted order (blobs[i] pairs with ord[i]) */
      for (int i = 0; i < n && !fail; i++) {
        PyObject *p = pay[ord[i].idx];
        if (!p) { lens[i] = 0; continue; }
        PyObject *b = PyMarshal_WriteObjectToString(p, Py_MARSHAL_VERSION);
        if (b) {
          lens[i] = (int64_t)PyBytes_GET_SIZE(b);
        } else {
          PyErr_Clear(); /* unmarshallable payload: pickle fallback */
          PyObject *pickle = PyImport_ImportModule("pickle");
          b = pickle ? PyObject_CallMethod(pickle, "dumps", "Oi", p, 4)
                     : NULL;
          Py_XDECREF(pickle);
          if (!b) { fail = 1; break; }
          lens[i] = -(int64_t)PyBytes_GET_SIZE(b);
        }
        blobs[i] = b;
      }
    }
    /* emit chunks of the sorted rows (chunks of a sorted list stay
     * sorted; each becomes its own pending batch at the receiver) */
    int start = 0;
    while (!fail && start < n) {
      int64_t sz = 8;
      int end = start;
      while (end < n) {
        int64_t row = 13 * 8 +
                      (blobs[end] ? (int64_t)PyBytes_GET_SIZE(blobs[end])
                                  : 0);
        if (end > start && sz + row > max_bytes) break;
        sz += row;
        end++;
      }
      int64_t m = end - start;
      PyObject *blk = PyBytes_FromStringAndSize(NULL, (Py_ssize_t)sz);
      if (!blk) { fail = 1; break; }
      char *w = PyBytes_AS_STRING(blk);
      memcpy(w, &m, 8);
      w += 8;
      for (int i = start; i < end; i++) {
        const SRec *s = &recs[ord[i].idx];
        /* pack_rows column order (= the 13-tuple store-row prefix) */
        int64_t cols[12] = {s->t,      s->key,   (int64_t)s->tgt,
                            (int64_t)s->kind,    (int64_t)s->peer,
                            (int64_t)s->aport,   (int64_t)s->bport,
                            s->nbytes, s->seq,   (int64_t)s->frag,
                            (int64_t)s->nfrags,  (int64_t)s->size};
        memcpy(w, cols, 12 * 8);
        w += 12 * 8;
      }
      memcpy(w, lens + start, (size_t)m * 8);
      w += m * 8;
      for (int i = start; i < end; i++) {
        if (blobs[i]) {
          Py_ssize_t bl = PyBytes_GET_SIZE(blobs[i]);
          memcpy(w, PyBytes_AS_STRING(blobs[i]), (size_t)bl);
          w += bl;
        }
      }
      if (PyList_Append(blocks, blk) < 0) { Py_DECREF(blk); fail = 1; }
      else Py_DECREF(blk);
      start = end;
    }
    if (blobs)
      for (int i = 0; i < n; i++) Py_XDECREF(blobs[i]);
    free(blobs);
    free(lens);
    free(ord);
    if (fail) {
      /* fatal, not retryable: shards drained in EARLIER iterations ride
       * the dropped `outer` blocks, so a caller must abort the run (the
       * shard worker does — the error propagates as a worker failure) */
      Py_DECREF(outer);
      if (!PyErr_Occurred()) PyErr_NoMemory();
      return NULL;
    }
    /* drained: release payload refs, reset the buffer */
    for (int i = 0; i < n; i++) Py_XDECREF(pay[i]);
    c->xn[j] = 0;
  }
  return outer;
}

static PyObject *Core_set_faults_active(CoreObject *c, PyObject *arg) {
  int v = PyObject_IsTrue(arg);
  if (v < 0) return NULL;
  c->faults_active = v;
  Py_RETURN_NONE;
}

/* Host.crash's C-side half: mark the CHost down (per-row dispatch
 * discards arrivals), drop the C-registered gossip handlers (a reboot
 * re-registers fresh state via gossip_register), and defensively clear
 * the transient inbox/egress buffers (both are empty at the round
 * starts where faults apply). The Python side of crash() — conns,
 * listeners, timers, parked rows — operates on the SHARED structures
 * this core caches, so it needs no C involvement. */
static PyObject *Core_host_crash(CoreObject *c, PyObject *arg) {
  int64_t hid = PyLong_AsLongLong(arg);
  if (hid == -1 && PyErr_Occurred()) return NULL;
  if (hid < 0 || hid >= c->H) {
    PyErr_SetString(PyExc_ValueError, "host id out of range");
    return NULL;
  }
  CHost *h = &c->hs[hid];
  h->down = 1;
  for (int j = 0; j < h->nports; j++) Py_CLEAR(h->gs[j]);
  h->nports = 0;
  for (int j = 0; j < h->inbox_n; j++) Py_CLEAR(h->inbox[j].payload);
  h->inbox_n = 0;
  h->inbox_multi = 0;
  for (int j = 0; j < h->erow_n; j++) Py_CLEAR(h->erow[j].payload);
  h->erow_n = 0;
  Py_RETURN_NONE;
}

static PyObject *Core_host_boot(CoreObject *c, PyObject *arg) {
  int64_t hid = PyLong_AsLongLong(arg);
  if (hid == -1 && PyErr_Occurred()) return NULL;
  if (hid < 0 || hid >= c->H) {
    PyErr_SetString(PyExc_ValueError, "host id out of range");
    return NULL;
  }
  c->hs[hid].down = 0;
  Py_RETURN_NONE;
}

/* transport column snapshot/adopt ABI (PR 11; defined after CEp below) */
static PyObject *Core_transport_columns(CoreObject *c, PyObject *noarg);
static PyObject *Core_adopt_transport_columns(CoreObject *c,
                                              PyObject *cols);

static PyMethodDef Core_methods[] = {
    {"transport_columns", (PyCFunction)Core_transport_columns,
     METH_NOARGS,
     "struct-of-arrays int64 snapshot of every C stream endpoint "
     "(network/devtransport.py COLUMNS twin; canonical host-id + "
     "sorted-connection-key order; pcap hosts' endpoints stay Python "
     "and are omitted — compare snapshots on pcap-free configs)"},
    {"adopt_transport_columns",
     (PyCFunction)Core_adopt_transport_columns, METH_O,
     "(cols dict) -> window-edge writeback of the ADOPT_COLUMNS subset "
     "(cwnd/ssthresh/cubic epoch/backoff) into live C endpoints; "
     "refuses by name when a row matches no live endpoint"},
    {"barrier", (PyCFunction)Core_barrier, METH_VARARGS,
     "end_of_round twin: (round_start, round_end) -> None | device batch"},
    {"extract", (PyCFunction)Core_extract, METH_VARARGS,
     "_extract twin: (round_end)"},
    {"refill_ingress", (PyCFunction)Core_refill_ingress, METH_VARARGS,
     "clamped ingress token refill for an elapsed window: (dt_ns)"},
    {"next_time", (PyCFunction)Core_next_time, METH_NOARGS,
     "min pending event time over the active hosts (skip-ahead)"},
    {"activate", (PyCFunction)Core_activate, METH_O,
     "(host_id) -> None  add a host to the active set (merge-tracked)"},
    {"flush_acks", (PyCFunction)Core_flush_acks, METH_O,
     "(ack_hosts) -> None  flush each host's coalesced barrier acks"},
    {"run_round", (PyCFunction)Core_run_round, METH_VARARGS,
     "per-round host loop over the bound active set: (round_end) -> n"},
    {"emit_row", (PyCFunction)Core_emit_row, METH_VARARGS,
     "packed emission (Host.emit_msg delegate): (hid, kind, dst, size, "
     "t_emit, sport, dport, nbytes, seq, frag, nfrags, payload)"},
    {"materialize_egress", (PyCFunction)Core_materialize_egress,
     METH_NOARGS,
     "flush packed C egress into host.egress_rows tuples (Python-barrier "
     "rounds: fault_filter)"},
    {"store_resolved", (PyCFunction)Core_store_resolved, METH_VARARGS,
     "(rows, src_l, arrival_l, keys_l, flags|None, round_end)"},
    {"bind_active", (PyCFunction)Core_bind_active, METH_O,
     "bind the controller's active-host-id set"},
    {"gossip_register", (PyCFunction)Core_gossip_register, METH_VARARGS,
     "(hid, port, peers) -> GossipState; registers the C dgram handler"},
    {"spec_demand", (PyCFunction)Core_spec_demand, METH_VARARGS,
     "(min_hosts=1) -> drain speculative-window demand once the queued "
     "cohort reaches min_hosts: (hosts, u0, n, npk_a, npk_b) arrays, or "
     "None; the first call enables speculation"},
    {"spec_install", (PyCFunction)Core_spec_install, METH_VARARGS,
     "(hosts, u0, n, npk_a, npk_b, off_a, off_b, mins) -> install one "
     "wave's prefix-min draws into the consult table"},
    {"spec_stats", (PyCFunction)Core_spec_stats, METH_NOARGS,
     "drain (speculative hits, inline draws since speculation enabled)"},
    {"fold_counters", (PyCFunction)Core_fold_counters, METH_NOARGS,
     "flush outstanding per-host counter deltas into host attributes"},
    {"make_endpoint", (PyCFunction)Core_make_endpoint, METH_VARARGS,
     "(hid, lport, rhost, rport, initiator, sbuf, rbuf) -> Endpoint"},
    {"relay_new", (PyCFunction)Core_relay_new, METH_VARARGS,
     "(hid, on_ctrl) -> Relay (C tor-relay data path)"},
    {"tor_client_sink", (PyCFunction)Core_tor_client_sink, METH_VARARGS,
     "(endpoint, on_cell) -> TorSink (C tor-client data path)"},
    {"bind_shard", (PyCFunction)Core_bind_shard, METH_VARARGS,
     "install the multi-process shard filter: (shard_id, n_shards, xout "
     "per-shard row lists — or None for the packed send path); "
     "cross-shard store rows divert into xout / the packed buffers"},
    {"take_xout_packed", (PyCFunction)Core_take_xout_packed, METH_VARARGS,
     "(max_bytes) -> [[bytes blocks] per shard]: drain the packed "
     "cross-shard egress as (t,key)-sorted shards.py wire-format blocks "
     "(the send-side twin of cbatch_from_packed)"},
    {"set_faults_active", (PyCFunction)Core_set_faults_active, METH_O,
     "(flag) -> enable the faults_active-gated accounting (blackhole/"
     "teardown per-host counts, stream recovery counters)"},
    {"host_crash", (PyCFunction)Core_host_crash, METH_O,
     "(hid) -> C-side host crash teardown (Host.crash delegates)"},
    {"host_boot", (PyCFunction)Core_host_boot, METH_O,
     "(hid) -> clear the C-side down flag (Host.reboot delegates)"},
    {"adopt", (PyCFunction)Core_adopt, METH_O,
     "(objs) -> bind checkpoint-restored C objects (endpoints, gossip "
     "states, relays) to this core (Controller._reattach_runtime)"},
    {NULL, NULL, 0, NULL}};

static PyTypeObject Core_Type = {
    PyVarObject_HEAD_INIT(NULL, 0).tp_name = "_colcore.Core",
    .tp_basicsize = sizeof(CoreObject),
    .tp_dealloc = (destructor)Core_dealloc,
    /* GC-tracked so the endpoint->core->conns->endpoint and
     * gossip-state cycles collect at simulation teardown (review r4) */
    .tp_flags = Py_TPFLAGS_DEFAULT | Py_TPFLAGS_HAVE_GC,
    .tp_traverse = (traverseproc)Core_traverse,
    .tp_clear = (inquiry)Core_clear_gc,
    .tp_methods = Core_methods,
    .tp_init = (initproc)Core_init,
    .tp_new = PyType_GenericNew,
    .tp_free = PyObject_GC_Del,
    .tp_doc = "C engine for one ColumnarPlane (plane._c)",
};


/* ======================================================================
 * C stream transport — the exact twin of network/transport.py's
 * StreamEndpoint/StreamSender/StreamReceiver, one object per connection
 * half. App callbacks (on_data, on_connected, ...) stay Python; all
 * protocol bookkeeping (windows, cumulative acks, OOO buffering,
 * retransmission, close handshakes) runs here. Timers go through the
 * host's Python event queue (bound-method tasks), so event identity and
 * ordering match the Python twin exactly.
 * ====================================================================== */

#define MSS_C 1460
#define INIT_CWND_C (10 * MSS_C)
#define MIN_CWND_C (2 * MSS_C)
#define RTO_MIN_NS_C 200000000LL
/* RTO ceiling (transport.py RTO_MAX_NS twin): a connection created
 * across a CUT path sees INF latency, and 2x that both overflows int64
 * and means "never retry" — cap like TCP's conventional 60 s max */
#define RTO_MAX_NS_C 60000000000LL
#define SYN_RETRIES_C 5
#define FIN_RETRIES_C 5
#define DATA_RETRIES_C 8
#define SACK_MAX_BLOCKS_C 4
/* congestion-control ids (transport.py CongestionControl.cc_id twins) */
#define CC_NEWRENO 0
#define CC_CUBIC 1
/* endpoint states (transport.py order) */
#define ST_CLOSED 0
#define ST_SYN_SENT 1
#define ST_ESTABLISHED 2
#define ST_CLOSING 3
#define ST_FIN_SENT 4
#define ST_TIME_WAIT 5

typedef struct { int64_t nbytes; PyObject *payload; } SQEnt;
typedef struct { int64_t seq, n; PyObject *payload; } RtxEnt;

/* grow-able ring (head + count) */
typedef struct { void *buf; int head, count, cap, esz; } Ring;

static int ring_grow(Ring *r) {
  int ncap = r->cap ? r->cap * 2 : 16;
  void *nb = malloc((size_t)ncap * (size_t)r->esz);
  if (!nb) { PyErr_NoMemory(); return -1; }
  for (int i = 0; i < r->count; i++)
    memcpy((char *)nb + (size_t)i * r->esz,
           (char *)r->buf + (size_t)((r->head + i) % r->cap) * r->esz,
           (size_t)r->esz);
  free(r->buf);
  r->buf = nb;
  r->head = 0;
  r->cap = ncap;
  return 0;
}

static inline void *ring_at(Ring *r, int i) {
  return (char *)r->buf + (size_t)((r->head + i) % r->cap) * r->esz;
}

static inline void *ring_push(Ring *r) {
  if (r->count == r->cap && ring_grow(r) < 0) return NULL;
  return ring_at(r, r->count++);
}

static inline void ring_popleft(Ring *r) {
  r->head = (r->head + 1) % r->cap;
  r->count--;
}

/* int64 seq-set over a Ring (the StreamSender sacked/rtx_done set
 * twins): membership is a linear scan — the sets hold at most a few
 * dozen in-flight segment seqs during a loss episode and are empty on
 * clean connections */
static int i64set_has(Ring *r, int64_t v) {
  for (int i = 0; i < r->count; i++)
    if (*(int64_t *)ring_at(r, i) == v) return 1;
  return 0;
}

static int i64set_add(Ring *r, int64_t v) {
  if (i64set_has(r, v)) return 0;
  int64_t *p = ring_push(r);
  if (!p) return -1;
  *p = v;
  return 0;
}

/* drop every member < cum (the cumulative-ack prune of the Python
 * set comprehension) — rebuilds in place, order irrelevant */
static void i64set_prune_below(Ring *r, int64_t cum) {
  int w = 0;
  for (int i = 0; i < r->count; i++) {
    int64_t v = *(int64_t *)ring_at(r, i);
    if (v >= cum) {
      *(int64_t *)ring_at(r, w) = v;
      w++;
    }
  }
  r->count = w;
}

/* tuple(sorted(set)) twin for fingerprint/export (cmp_i64 above) */
static PyObject *i64set_sorted_tuple(Ring *r) {
  int n = r->count;
  int64_t *tmp = n ? malloc((size_t)n * sizeof(int64_t)) : NULL;
  if (n && !tmp) return PyErr_NoMemory();
  for (int i = 0; i < n; i++) tmp[i] = *(int64_t *)ring_at(r, i);
  if (n) qsort(tmp, (size_t)n, sizeof(int64_t), cmp_i64);
  PyObject *t = PyTuple_New(n);
  if (!t) { free(tmp); return NULL; }
  for (int i = 0; i < n; i++) {
    PyObject *v = PyLong_FromLongLong(tmp[i]);
    if (!v) { free(tmp); Py_DECREF(t); return NULL; }
    PyTuple_SET_ITEM(t, i, v);
  }
  free(tmp);
  return t;
}

/* restore from an exported tuple of ints */
static int i64set_restore(Ring *r, PyObject *tup) {
  if (!PyTuple_Check(tup)) {
    PyErr_SetString(PyExc_TypeError, "seq-set restore: want a tuple");
    return -1;
  }
  for (Py_ssize_t i = 0; i < PyTuple_GET_SIZE(tup); i++) {
    int64_t v = PyLong_AsLongLong(PyTuple_GET_ITEM(tup, i));
    if (v == -1 && PyErr_Occurred()) return -1;
    if (i64set_add(r, v) < 0) return -1;
  }
  return 0;
}

/* floor integer cube root (transport.py _icbrt twin: same binary
 * search, operands < 2**60 so int64 is exact) */
static int64_t icbrt64(int64_t x) {
  int64_t lo = 0, hi = 1LL << 20;
  while (lo < hi) {
    int64_t mid = (lo + hi + 1) >> 1;
    if (mid * mid * mid <= x) lo = mid;
    else hi = mid - 1;
  }
  return lo;
}

typedef struct CEp {
  PyObject_HEAD
  CoreObject *core; /* owned */
  int hid;
  int local_port, remote_host, remote_port;
  int initiator, state, syn_tries, fin_tries, peer_fin;
  int64_t rto_ns;
  PyObject *ctl_timer; /* owned PyLong handle, or NULL */
  /* opt-in idle timeout (StreamEndpoint.set_idle_timeout twin): rearmed
   * on every arrival, expiry surfaces ETIMEDOUT — the pure-receiver
   * dead-peer detector fault configs rely on (faults.py) */
  int64_t idle_timeout_ns; /* 0 = off */
  PyObject *idle_timer; /* owned PyLong handle, or NULL */
  /* sender */
  int64_t chunk, cwnd, ssthresh, send_buffer, snd_nxt, snd_una, adv_wnd;
  int64_t buffered, bytes_acked;
  int64_t rto_backoff;
  int retries, loss_events;
  PyObject *rto_timer; /* owned PyLong handle, or NULL */
  Ring sendbuf; /* SQEnt */
  Ring rtx;     /* RtxEnt */
  /* receiver */
  int64_t recv_buffer, rcv_nxt, ooo_bytes, bytes_received, last_wnd;
  int dup_acks; /* consecutive duplicate acks (RFC 5681 counting) */
  /* SACK scoreboard + congestion-control seam (StreamSender twins):
   * sacked/rtx_done are int64 seq sets (tiny; linear membership),
   * sack_high the highest SACKed byte since the last RTO, recover the
   * recovery point, w_max/epoch_start the cubic epoch state */
  int cc_kind;
  int in_recovery;
  int64_t recover, sack_high, w_max, epoch_start;
  Ring sacked;   /* int64_t */
  Ring rtx_done; /* int64_t */
  Ring ooo; /* RtxEnt, kept seq-sorted (insertion) */
  PyObject *app_unread; /* callable or NULL */
  /* app callbacks (None when unset) */
  PyObject *on_connected, *on_data, *on_drain, *on_close, *on_error;
  /* C fast sink: when set, data delivery / drain / close route to the
   * C relay machinery instead of the Python callbacks */
  struct CRelayConn *sink;
  /* C tor-client sink (borrowed back-pointer; the sink owns the ep):
   * terminal frame parsing + DATA-body byte counting in C, one Python
   * callback per CONTROL cell (models/tor.py TorClient twin) */
  struct CTorSink *tsink;
  /* C tor-exit stream (OWNED; the stream borrows the ep back): counted
   * server bytes re-framed as circuit DATA cells in C (TorExit twin) */
  PyObject *xsink;
  /* C tgen app (models/tgen.py twin; same opt-in style as the relay
   * sink): 0 = none, 1 = server (parse the 8-byte ASCII request, push
   * counted bytes), 2 = client (count received bytes, fire tgen_cb at
   * completion). Replaces the per-row Python on_data / per-ack
   * on_drain closures with C state; only once-per-transfer events
   * (request seen, transfer complete) call back into Python. */
  int tgen_mode;
  int64_t tgen_pending; /* server: bytes left to push; client: received */
  int64_t tgen_want;    /* client: completion target */
  PyObject *tgen_cb;    /* server: on_request(want); client: cb(now, got) */
  /* telemetry (shadow_tpu/telemetry/): sim time of the first delivered
   * response byte in tgen client mode, -1 until one arrives — the exact
   * twin of the Python model's first-on_data capture (the flow record's
   * TTFB field reads it through the tgen_t_first getter) */
  int64_t tgen_t_first;
} CEp;

static PyTypeObject CEp_Type; /* fwd */
struct CRelayConn;
static int relay_feed(struct CRelayConn *rc, int64_t now, int64_t nbytes,
                      PyObject *payload);
static int relay_pump_conn(struct CRelayConn *rc, int64_t now);
static int relay_drain(struct CRelayConn *rc, int64_t now);
static int relay_conn_closed(struct CRelayConn *rc);

static CHost *cep_h(CEp *e) { return &e->core->hs[e->hid]; }

struct CTorSink;
static int tsink_feed(struct CTorSink *s, int64_t nbytes,
                      PyObject *payload);
static int tsink_pump(struct CTorSink *s, int64_t now);
struct CExitStream;
static int exit_feed(struct CExitStream *s, int64_t now, int64_t nbytes);

/* current sim clock of the owning host: used by timer-driven entry
 * points; row-driven entry points pass `now` explicitly */
static int64_t cep_now(CEp *e, int *err) {
  int64_t v;
  if (attr_i64(cep_h(e)->host, S_now, &v) < 0) { *err = 1; return 0; }
  *err = 0;
  return v;
}

static PyObject *S_schedule_in, *S_cancel_m, *S_rto_fire, *S_syn_fire,
    *S_fin_fire, *S_drop_fire, *S_idle_fire, *S_seq_ctr, *S_on_first;

static int64_t cep_window(CEp *e, int *err) {
  *err = 0;
  int64_t unread = 0;
  if (e->app_unread && e->app_unread != Py_None) {
    PyObject *r = PyObject_CallNoArgs(e->app_unread);
    if (!r) { *err = 1; return 0; }
    unread = PyLong_AsLongLong(r);
    Py_DECREF(r);
    if (unread == -1 && PyErr_Occurred()) { *err = 1; return 0; }
  }
  int64_t w = e->recv_buffer - e->ooo_bytes - unread;
  return w > 0 ? w : 0;
}

static int cep_emit(CEp *e, int64_t now, int kind, int64_t nbytes,
                    PyObject *payload, int64_t seq, int64_t acked,
                    int64_t wnd) {
  return core_emit_fields(
      e->core, cep_h(e), now, kind, e->remote_host, nbytes + HEADER,
      kind == TK_DATA ? nbytes : acked, payload,
      kind == TK_DATA ? seq : wnd, e->local_port, e->remote_port, 0, 1);
}

/* receiver._ack: round-barrier coalesced ack (Host.mark_ack twin) over
 * the cached identity-stable _ack_eps dict */
static int cep_mark_ack(CEp *e) {
  CHost *h = cep_h(e);
  PyObject *aeps = h->ack_eps;
  if (PyDict_GET_SIZE(aeps) == 0) {
    PyObject *al = PyObject_GetAttrString(e->core->plane, "ack_hosts");
    if (!al) return -1;
    int r = PyList_Append(al, h->host);
    Py_DECREF(al);
    if (r < 0) return -1;
  }
  return PyDict_SetItem(aeps, (PyObject *)e, Py_None);
}

/* timers ride the host's Python event queue so seq/order match the twin
 * — but the push itself runs here (EventQueue.push twin over the cached
 * heap/_live/_seq structures): at tor_100k scale the per-unit RTO
 * arm/cancel churn through two Python method calls was a first-order
 * cost of the host loop. The shared _seq counter keeps C and Python
 * pushes on one deterministic sequence. */
static int cep_schedule(CEp *e, int64_t delay, PyObject *meth_name,
                        PyObject **slot) {
  CHost *h = cep_h(e);
  int64_t now;
  if (attr_i64(h->host, S_now, &now) < 0) return -1;
  int64_t seq;
  if (attr_i64(h->equeue, S_seq_ctr, &seq) < 0) return -1;
  PyObject *task = PyObject_GetAttr((PyObject *)e, meth_name);
  if (!task) return -1;
  PyObject *seq_obj = PyLong_FromLongLong(seq);
  /* (time, band=BAND_APP, key=seq, seq, task) — schedule_in's default
   * band/key exactly (key < 0 resolves to seq) */
  PyObject *entry = seq_obj
      ? Py_BuildValue("(LiOOO)", (long long)(now + delay), 1, seq_obj,
                      seq_obj, task)
      : NULL;
  Py_DECREF(task);
  if (!entry) { Py_XDECREF(seq_obj); return -1; }
  int was_empty = PyList_GET_SIZE(h->heap) == 0;
  if (heap_push(h->heap, entry) < 0 ||
      PySet_Add(h->live, seq_obj) < 0 ||
      attr_set_i64(h->equeue, S_seq_ctr, seq + 1) < 0) {
    Py_DECREF(seq_obj);
    return -1;
  }
  if (was_empty) {
    PyObject *of = PyObject_GetAttr(h->equeue, S_on_first);
    if (!of) { Py_DECREF(seq_obj); return -1; }
    if (of != Py_None) {
      PyObject *r = PyObject_CallNoArgs(of);
      Py_DECREF(of);
      if (!r) { Py_DECREF(seq_obj); return -1; }
      Py_DECREF(r);
    } else {
      Py_DECREF(of);
    }
  }
  Py_XSETREF(*slot, seq_obj); /* the handle is the seq int, like push() */
  return 0;
}

static int cep_cancel_timer(CEp *e, PyObject **slot) {
  if (!*slot) return 0;
  CHost *h = cep_h(e);
  /* EventQueue.cancel twin: lazy-cancel iff still live */
  int live = PySet_Contains(h->live, *slot);
  if (live < 0) { Py_CLEAR(*slot); return -1; }
  if (live && PySet_Add(h->cancelled, *slot) < 0) {
    Py_CLEAR(*slot);
    return -1;
  }
  Py_CLEAR(*slot);
  return 0;
}

static int cs_pump(CEp *e, int64_t now);
static int64_t cs_send(CEp *e, int64_t now, int64_t nbytes,
                       PyObject *payload, int64_t off);
static int tgen_push(CEp *e, int64_t now);
static int ce_sender_drained(CEp *e, int64_t now);
static int ce_drop(CEp *e);
static int ce_reset(CEp *e, const char *reason);
static int ce_enter_time_wait(CEp *e, int64_t now);

static int cs_arm_rto(CEp *e, int reset) {
  if (reset && e->rto_timer) {
    if (cep_cancel_timer(e, &e->rto_timer) < 0) return -1;
  }
  if (!e->rto_timer)
    return cep_schedule(e, e->rto_ns * e->rto_backoff, S_rto_fire,
                        &e->rto_timer);
  return 0;
}

static int cs_emit_data(CEp *e, int64_t now, int64_t seq, int64_t nbytes,
                        PyObject *payload) {
  /* recovery comes entirely from duplicate acks, like the Python twin */
  return cep_emit(e, now, TK_DATA, nbytes, payload, seq, 0, 0);
}

static int cs_pump(CEp *e, int64_t now) {
  if (e->state != ST_ESTABLISHED && e->state != ST_CLOSING) return 0;
  int64_t window = e->adv_wnd > MSS_C ? e->adv_wnd : MSS_C;
  if (e->cwnd < window) window = e->cwnd;
  while (e->buffered > 0 && (e->snd_nxt - e->snd_una) < window) {
    int64_t inflight = e->snd_nxt - e->snd_una;
    int64_t usable = window - inflight;
    /* silly-window avoidance (transport.py pump) */
    if (usable < e->chunk && usable < e->buffered && inflight > 0) break;
    int64_t budget = usable < e->chunk ? usable : e->chunk;
    SQEnt *head = ring_at(&e->sendbuf, 0);
    int64_t nbytes = head->nbytes;
    PyObject *chunk_p = NULL;
    if (nbytes <= budget) {
      chunk_p = head->payload; /* transfer ownership */
      ring_popleft(&e->sendbuf);
    } else {
      if (head->payload && head->payload != Py_None) {
        chunk_p = PySequence_GetSlice(head->payload, 0, budget);
        PyObject *rest = PySequence_GetSlice(head->payload, budget,
                                             PyBytes_GET_SIZE(head->payload));
        if (!chunk_p || !rest) {
          Py_XDECREF(chunk_p); Py_XDECREF(rest);
          return -1;
        }
        Py_SETREF(head->payload, rest);
      }
      head->nbytes = nbytes - budget;
      nbytes = budget;
    }
    e->buffered -= nbytes;
    int64_t seq = e->snd_nxt;
    e->snd_nxt += nbytes;
    RtxEnt *re = ring_push(&e->rtx);
    if (!re) { Py_XDECREF(chunk_p); return -1; }
    re->seq = seq;
    re->n = nbytes;
    re->payload = chunk_p; /* owned (may be NULL) */
    if (cs_emit_data(e, now, seq, nbytes, chunk_p) < 0) return -1;
  }
  if (e->snd_nxt - e->snd_una > 0) {
    if (cs_arm_rto(e, 0) < 0) return -1;
  } else if (e->buffered == 0) {
    return ce_sender_drained(e, now);
  }
  return 0;
}

/* ---- congestion control (transport.py CongestionControl twins) --------- */
static void cc_on_ack(CEp *e, int64_t newly, int64_t now) {
  if (e->cwnd < e->ssthresh) {
    e->cwnd += newly < e->cwnd ? newly : e->cwnd; /* slow start (shared) */
    return;
  }
  if (e->cc_kind == CC_CUBIC) {
    if (e->epoch_start == 0) { /* first CA ack with no recorded epoch */
      e->epoch_start = now;
      e->w_max = e->cwnd;
    }
    int64_t t_ms = (now - e->epoch_start) / 1000000LL;
    int64_t wmax_c = e->w_max < (1LL << 32) ? e->w_max : (1LL << 32);
    int64_t k_ms = icbrt64((wmax_c * 3 / (4 * MSS_C)) * 1000000000LL);
    int64_t d = t_ms - k_ms;
    if (d > 200000) d = 200000;
    else if (d < -200000) d = -200000;
    int64_t a = d < 0 ? -d : d;
    int64_t delta = (a * a * a / 1000000LL) * (4 * MSS_C) / 10000LL;
    int64_t target = d < 0 ? e->w_max - delta : e->w_max + delta;
    if (target < MIN_CWND_C) target = MIN_CWND_C;
    else if (target > (1LL << 45)) target = 1LL << 45;
    int64_t nn = newly < (1LL << 20) ? newly : (1LL << 20);
    if (e->cwnd < target) {
      int64_t dd = target - e->cwnd;
      if (dd > (1LL << 40)) dd = 1LL << 40;
      int64_t inc = dd * nn / e->cwnd;
      int64_t nw = e->cwnd + (inc > 1 ? inc : 1);
      e->cwnd = nw < target ? nw : target;
    } else {
      int64_t inc = MSS_C * nn / (100 * e->cwnd);
      e->cwnd += inc > 1 ? inc : 1;
    }
    return;
  }
  int64_t add = MSS_C * newly / e->cwnd;
  e->cwnd += add > 1 ? add : 1; /* newreno AIMD */
}

static void cc_on_loss(CEp *e, int64_t now) {
  if (e->cc_kind == CC_CUBIC) {
    e->w_max = e->cwnd;
    e->epoch_start = now;
    int64_t nc = e->cwnd * 7 / 10;
    e->ssthresh = e->cwnd = nc > MIN_CWND_C ? nc : MIN_CWND_C;
    return;
  }
  int64_t inflight = e->snd_nxt - e->snd_una;
  e->ssthresh = inflight / 2 > MIN_CWND_C ? inflight / 2 : MIN_CWND_C;
  e->cwnd = e->cwnd / 2 > MIN_CWND_C ? e->cwnd / 2 : MIN_CWND_C;
}

static void cc_on_rto(CEp *e, int64_t now) {
  if (e->cc_kind == CC_CUBIC) {
    e->w_max = e->cwnd;
    e->epoch_start = now;
  }
  int64_t inflight = e->snd_nxt - e->snd_una;
  e->ssthresh = inflight / 2 > MIN_CWND_C ? inflight / 2 : MIN_CWND_C;
  e->cwnd = MIN_CWND_C;
}

/* ---- SACK scoreboard (StreamSender twins) ------------------------------ */
/* fold an ack's SACK blocks (big-endian u64 pairs in the payload) into
 * the scoreboard (StreamSender._apply_sack twin) */
static int cs_apply_sack(CEp *e, PyObject *payload) {
  if (!payload || !PyBytes_Check(payload)) return 0;
  const unsigned char *p = (const unsigned char *)PyBytes_AS_STRING(payload);
  Py_ssize_t len = PyBytes_GET_SIZE(payload);
  for (Py_ssize_t off = 0; off + 16 <= len; off += 16) {
    int64_t a = 0, b = 0;
    for (int i = 0; i < 8; i++) a = (a << 8) | p[off + i];
    for (int i = 0; i < 8; i++) b = (b << 8) | p[off + 8 + i];
    if (b > e->sack_high) e->sack_high = b;
    for (int i = 0; i < e->rtx.count; i++) {
      RtxEnt *re = ring_at(&e->rtx, i);
      if (re->seq >= b) break; /* rtx is seq-ascending */
      if (re->seq >= a && re->seq + re->n <= b) {
        if (i64set_add(&e->sacked, re->seq) < 0) return -1;
      }
    }
  }
  return 0;
}

/* retransmit every un-SACKed, not-yet-retransmitted hole below the
 * highest SACKed byte (StreamSender._retransmit_holes twin); returns
 * the emission count or -1 */
static int cs_retransmit_holes(CEp *e, int64_t now, int force_head) {
  int64_t hi = e->sack_high;
  int emitted = 0;
  for (int i = 0; i < e->rtx.count; i++) {
    RtxEnt *re = ring_at(&e->rtx, i);
    if (re->seq >= hi && !(force_head && i == 0)) break;
    if (i64set_has(&e->sacked, re->seq) ||
        i64set_has(&e->rtx_done, re->seq))
      continue;
    if (i64set_add(&e->rtx_done, re->seq) < 0) return -1;
    if (cs_emit_data(e, now, re->seq, re->n, re->payload) < 0) return -1;
    emitted++;
  }
  return emitted;
}

/* the fast-retransmit response (3rd consecutive duplicate ack):
 * multiplicative decrease + retransmit of every known hole + RTO reset
 * (StreamSender._enter_recovery twin) */
static int cs_enter_recovery(CEp *e, int64_t now) {
  e->loss_events++;
  if (e->core->faults_active) cep_h(e)->d_fast_retx++;
  e->in_recovery = 1;
  e->recover = e->snd_nxt;
  e->rtx_done.count = 0;
  cc_on_loss(e, now);
  int emitted = cs_retransmit_holes(e, now, 1);
  if (emitted < 0) return -1;
  if (emitted > 1 && e->core->faults_active)
    cep_h(e)->d_sack_retx += emitted - 1;
  return cs_arm_rto(e, 1);
}

static int cs_on_rto(CEp *e, int64_t now) {
  Py_CLEAR(e->rto_timer);
  if (e->snd_nxt - e->snd_una == 0 || e->state == ST_CLOSED ||
      e->state == ST_TIME_WAIT)
    return 0;
  if (e->adv_wnd > 0) e->retries++;
  if (e->retries > DATA_RETRIES_C) {
    if (e->core->faults_active) cep_h(e)->d_timeouts++;
    return ce_reset(e, "connection timed out (ETIMEDOUT): data retransmission retries exhausted");
  }
  if (e->core->faults_active) cep_h(e)->d_rto_retx++;
  /* scoreboard discarded (renege safety, StreamSender._on_rto twin) */
  e->sacked.count = 0;
  e->rtx_done.count = 0;
  e->sack_high = 0;
  e->in_recovery = 0;
  cc_on_rto(e, now);
  e->rto_backoff = e->rto_backoff * 2 > 64 ? 64 : e->rto_backoff * 2;
  RtxEnt *re = ring_at(&e->rtx, 0);
  if (cs_emit_data(e, now, re->seq, re->n, re->payload) < 0) return -1;
  return cs_arm_rto(e, 0);
}

static int cs_on_ack(CEp *e, int64_t now, int64_t cum_ack, int64_t wnd,
                     PyObject *sack) {
  int64_t prev_wnd = e->adv_wnd;
  e->adv_wnd = wnd;
  if (sack && cs_apply_sack(e, sack) < 0) return -1;
  if (cum_ack > e->snd_una) {
    e->dup_acks = 0;
    int64_t newly = cum_ack - e->snd_una;
    e->snd_una = cum_ack;
    e->bytes_acked += newly;
    while (e->rtx.count) {
      RtxEnt *re = ring_at(&e->rtx, 0);
      if (re->seq + re->n > cum_ack) break;
      Py_XDECREF(re->payload);
      ring_popleft(&e->rtx);
    }
    if (e->sacked.count) i64set_prune_below(&e->sacked, cum_ack);
    if (e->rtx_done.count) i64set_prune_below(&e->rtx_done, cum_ack);
    e->rto_backoff = 1;
    e->retries = 0;
    if (cep_cancel_timer(e, &e->rto_timer) < 0) return -1;
    if (e->snd_nxt - e->snd_una > 0) {
      if (cs_arm_rto(e, 0) < 0) return -1;
    }
    if (e->in_recovery) {
      if (e->snd_una >= e->recover) {
        e->in_recovery = 0;
        e->rtx_done.count = 0;
      } else {
        /* partial ack: NewReno head retransmit + newly exposed holes */
        int n = cs_retransmit_holes(e, now, 1);
        if (n < 0) return -1;
        if (n && e->core->faults_active) cep_h(e)->d_sack_retx += n;
      }
    }
    cc_on_ack(e, newly, now);
    if (e->sink && e->buffered < e->send_buffer) {
      if (relay_drain(e->sink, now) < 0) return -1;
    } else if (e->tsink && e->buffered < e->send_buffer) {
      /* the tor-client control plane's pending-write queue (the
       * _WriteConn on_drain pump twin) */
      if (tsink_pump(e->tsink, now) < 0) return -1;
    } else if (e->tgen_mode == 1 && e->buffered < e->send_buffer) {
      /* TGenServer on_drain twin (push is a no-op with no backlog,
       * exactly like the Python closure called with room) */
      if (tgen_push(e, now) < 0) return -1;
    } else if (e->on_drain && e->on_drain != Py_None &&
        e->buffered < e->send_buffer) {
      PyObject *room = PyLong_FromLongLong(e->send_buffer - e->buffered);
      if (!room) return -1;
      PyObject *r = PyObject_CallOneArg(e->on_drain, room);
      Py_DECREF(room);
      if (!r) return -1;
      Py_DECREF(r);
    }
  } else if (cum_ack == e->snd_una &&
             wnd == prev_wnd && e->snd_nxt - e->snd_una > 0 &&
             e->rtx.count) {
    /* duplicate ack (same cum, same window, data outstanding): 3rd
     * CONSECUTIVE one enters SACK recovery (StreamSender twin) */
    e->dup_acks++;
    if (e->dup_acks == 3 && !e->in_recovery) {
      if (cs_enter_recovery(e, now) < 0) return -1;
    } else if (e->in_recovery && sack) {
      /* later dup acks can expose new holes (higher sack_high) */
      int n = cs_retransmit_holes(e, now, 0);
      if (n < 0) return -1;
      if (n && e->core->faults_active) cep_h(e)->d_sack_retx += n;
    }
  } else {
    e->dup_acks = 0; /* anything else breaks the consecutive run */
  }
  return cs_pump(e, now);
}

/* ---- C tgen app (models/tgen.py twin) ---------------------------------- */
static int tgen_push(CEp *e, int64_t now) {
  /* TGenServer.push twin: offer the whole backlog; the bounded send
   * buffer accepts what fits, the rest streams out via the ack drain */
  if (e->tgen_pending <= 0) return 0;
  int64_t acc = cs_send(e, now, e->tgen_pending, NULL, 0);
  if (acc < 0) return -1;
  e->tgen_pending -= acc;
  return 0;
}

static int is_strip_ws(char ch) {
  /* str.strip()'s ASCII whitespace set (NUL etc. are NOT whitespace) */
  return ch == ' ' || ch == '\t' || ch == '\n' || ch == '\r' ||
         ch == '\v' || ch == '\f';
}

static int tgen_srv_data(CEp *e, int64_t now, PyObject *payload) {
  /* int(payload.decode().strip()) twin: want = 0 on any parse failure,
   * each payload chunk parsed independently (like the Python closure).
   * Exact for ASCII decimal (incl. sign and between-digit underscores)
   * up to int64; declared divergences from Python int(): values beyond
   * int64 and non-ASCII Unicode digits parse as 0 here (a request for
   * >9.2e18 counted bytes is non-physical, and the wire format —
   * str(size).encode() — never produces either). */
  int64_t want = 0;
  if (payload && PyBytes_Check(payload)) {
    const char *s = PyBytes_AS_STRING(payload);
    Py_ssize_t i = 0, j = PyBytes_GET_SIZE(payload);
    while (i < j && is_strip_ws(s[i])) i++;
    while (j > i && is_strip_ws(s[j - 1])) j--;
    Py_ssize_t k = i;
    int neg = 0, last_digit = 0, ok = k < j;
    if (k < j && (s[k] == '+' || s[k] == '-')) { neg = s[k] == '-'; k++; }
    if (k >= j) ok = 0;
    for (; ok && k < j; k++) {
      if (s[k] == '_') {
        /* Python: underscores only BETWEEN digits */
        if (!last_digit || k + 1 >= j) ok = 0;
        last_digit = 0;
        continue;
      }
      if (s[k] < '0' || s[k] > '9') { ok = 0; break; }
      if (want > (INT64_MAX - (s[k] - '0')) / 10) { ok = 0; break; }
      want = want * 10 + (s[k] - '0');
      last_digit = 1;
    }
    if (!ok || !last_digit) want = 0;
    else if (neg) want = -want;
  }
  if (want <= 0) return 0;
  if (e->tgen_cb && e->tgen_cb != Py_None) {
    PyObject *w = PyLong_FromLongLong(want);
    if (!w) return -1;
    PyObject *r = PyObject_CallOneArg(e->tgen_cb, w);
    Py_DECREF(w);
    if (!r) return -1;
    Py_DECREF(r);
  }
  e->tgen_pending += want;
  return tgen_push(e, now);
}

typedef struct { int64_t seq, n; } SackSeg;

static int cmp_sackseg(const void *a, const void *b) {
  int64_t x = ((const SackSeg *)a)->seq, y = ((const SackSeg *)b)->seq;
  return (x > y) - (x < y);
}

/* the receiver's SACK report (StreamReceiver.sack_payload twin): the
 * buffered OOO segments merged into contiguous [start, end) ranges, the
 * lowest SACK_MAX_BLOCKS_C of them, as big-endian u64 pairs. Returns a
 * new bytes ref, NULL with *err=0 when nothing is buffered (no
 * payload — every ack of a loss-free connection), NULL with *err=1 on
 * allocation failure. Byte-identical to the Python builder. */
static PyObject *cr_sack_payload(CEp *e, int *err) {
  *err = 0;
  int n = e->ooo.count;
  if (n == 0) return NULL;
  SackSeg stack_segs[32];
  SackSeg *segs = n <= 32 ? stack_segs
                          : malloc((size_t)n * sizeof(SackSeg));
  if (!segs) { PyErr_NoMemory(); *err = 1; return NULL; }
  for (int i = 0; i < n; i++) {
    RtxEnt *re = ring_at(&e->ooo, i);
    segs[i].seq = re->seq;
    segs[i].n = re->n;
  }
  qsort(segs, (size_t)n, sizeof(SackSeg), cmp_sackseg);
  unsigned char buf[SACK_MAX_BLOCKS_C * 16];
  int nb = 0, nblocks = 0;
  int64_t cs = segs[0].seq, ce = segs[0].seq + segs[0].n;
  for (int i = 1; i <= n && nblocks < SACK_MAX_BLOCKS_C; i++) {
    if (i < n && segs[i].seq == ce) {
      ce = segs[i].seq + segs[i].n;
      continue;
    }
    for (int k = 7; k >= 0; k--) buf[nb++] = (cs >> (8 * k)) & 0xff;
    for (int k = 7; k >= 0; k--) buf[nb++] = (ce >> (8 * k)) & 0xff;
    nblocks++;
    if (i < n) { cs = segs[i].seq; ce = segs[i].seq + segs[i].n; }
  }
  if (segs != stack_segs) free(segs);
  PyObject *r = PyBytes_FromStringAndSize((const char *)buf, nb);
  if (!r) *err = 1;
  return r;
}

/* out-of-order / duplicate / out-of-window data: real TCP acks
 * IMMEDIATELY (RFC 5681 §4.2 — dup acks drive the sender's
 * fast-retransmit counter). Supersedes any coalesced ack queued this
 * round (a same-cum barrier ack would inflate the dup count) — the
 * StreamReceiver._dup_ack twin. */
static int cep_dup_ack(CEp *e, int64_t now) {
  if (e->state == ST_CLOSED || e->state == ST_TIME_WAIT) return 0;
  CHost *h = cep_h(e);
  PyObject *aeps = h->ack_eps;
  int had = PyDict_Contains(aeps, (PyObject *)e);
  if (had < 0) return -1;
  if (had && PyDict_DelItem(aeps, (PyObject *)e) < 0) return -1;
  /* re-advertise last_wnd (NOT the recomputed window): buffering the
   * OOO segment shrinks window() every time, which would defeat the
   * sender's same-window dup test — see StreamReceiver._dup_ack */
  int err;
  PyObject *sp = cr_sack_payload(e, &err);
  if (err) return -1;
  int r = cep_emit(e, now, TK_ACK, 0, sp, 0, e->rcv_nxt, e->last_wnd);
  Py_XDECREF(sp);
  return r;
}

/* ---- receiver (StreamReceiver twin) ------------------------------------ */
static int cr_deliver(CEp *e, int64_t now, int64_t nbytes,
                      PyObject *payload) {
  e->rcv_nxt += nbytes;
  e->bytes_received += nbytes;
  if (e->tsink)
    return tsink_feed(e->tsink, nbytes, payload);
  if (e->xsink)
    return exit_feed((struct CExitStream *)e->xsink, now, nbytes);
  if (e->tgen_mode == 2) {
    if (e->tgen_t_first < 0) e->tgen_t_first = now;
    e->tgen_pending += nbytes;
    if (e->tgen_pending >= e->tgen_want && e->tgen_cb &&
        e->tgen_cb != Py_None) {
      PyObject *r = PyObject_CallFunction(e->tgen_cb, "LL", (long long)now,
                                          (long long)e->tgen_pending);
      if (!r) return -1;
      Py_DECREF(r);
    }
    return 0;
  }
  if (e->tgen_mode == 1)
    return tgen_srv_data(e, now, payload);
  if (e->sink)
    return relay_feed(e->sink, now, nbytes, payload);
  if (e->on_data && e->on_data != Py_None) {
    PyObject *nb = PyLong_FromLongLong(nbytes);
    PyObject *tn = PyLong_FromLongLong(now);
    if (!nb || !tn) { Py_XDECREF(nb); Py_XDECREF(tn); return -1; }
    PyObject *r = PyObject_CallFunctionObjArgs(
        e->on_data, nb, payload ? payload : Py_None, tn, NULL);
    Py_DECREF(nb);
    Py_DECREF(tn);
    if (!r) return -1;
    Py_DECREF(r);
  }
  return 0;
}

static int cr_ooo_find(CEp *e, int64_t seq) {
  for (int i = 0; i < e->ooo.count; i++)
    if (((RtxEnt *)ring_at(&e->ooo, i))->seq == seq) return i;
  return -1;
}

static int cr_on_data(CEp *e, int64_t now, int64_t seq, int64_t n,
                      PyObject *payload) {
  int err;
  if (seq + n <= e->rcv_nxt) return cep_dup_ack(e, now); /* duplicate */
  if (seq > e->rcv_nxt) {
    if (cr_ooo_find(e, seq) < 0) {
      int64_t w = cep_window(e, &err);
      if (err) return -1;
      if (n <= w) {
        RtxEnt *oe = ring_push(&e->ooo);
        if (!oe) return -1;
        oe->seq = seq;
        oe->n = n;
        Py_XINCREF(payload);
        oe->payload = payload;
        e->ooo_bytes += n;
      }
    }
    return cep_dup_ack(e, now); /* duplicate ack: rcv_nxt unchanged */
  }
  int64_t w = cep_window(e, &err);
  if (err) return -1;
  /* beyond-window probe: refuse + COALESCED re-advertisement (not a dup
   * ack — counting probe refusals toward fast retransmit would halve
   * cwnd during a stall where nothing was lost) */
  if (n > w) return cep_mark_ack(e);
  if (cr_deliver(e, now, n, payload) < 0) return -1;
  for (;;) {
    int i = cr_ooo_find(e, e->rcv_nxt);
    if (i < 0) break;
    RtxEnt cp = *(RtxEnt *)ring_at(&e->ooo, i);
    /* remove entry i (order within the ring is irrelevant) */
    *(RtxEnt *)ring_at(&e->ooo, i) =
        *(RtxEnt *)ring_at(&e->ooo, e->ooo.count - 1);
    e->ooo.count--;
    e->ooo_bytes -= cp.n;
    int r = cr_deliver(e, now, cp.n, cp.payload);
    Py_XDECREF(cp.payload);
    if (r < 0) return -1;
  }
  return cep_mark_ack(e);
}

/* ---- endpoint (StreamEndpoint twin) ------------------------------------ */
static int ce_cancel_ctl(CEp *e) { return cep_cancel_timer(e, &e->ctl_timer); }

static int ce_drop(CEp *e) {
  if (ce_cancel_ctl(e) < 0) return -1;
  if (cep_cancel_timer(e, &e->rto_timer) < 0) return -1;
  if (cep_cancel_timer(e, &e->idle_timer) < 0) return -1;
  e->state = ST_CLOSED;
  e->tsink = NULL; /* borrowed back-pointer; the sink still owns us */
  Py_CLEAR(e->xsink); /* the exit stream dies with its server conn */
  /* host.drop_endpoint twin: pop our four-tuple from the cached
   * identity-stable host._conns dict */
  PyObject *conns = cep_h(e)->conns;
  PyObject *key = Py_BuildValue("(iii)", e->local_port, e->remote_host,
                                e->remote_port);
  if (!key) return -1;
  if (PyDict_Contains(conns, key) == 1) {
    if (PyDict_DelItem(conns, key) < 0) { Py_DECREF(key); return -1; }
  }
  Py_DECREF(key);
  return 0;
}

static int ce_reset(CEp *e, const char *reason) {
  cep_h(e)->d_resets++;
  /* sink conns mirror the Python twin exactly: _reset only fires
   * on_error (unset for relay conns) and drops the endpoint — the
   * relay's conn/table entries go stale, with NO teardown cascade */
  PyObject *err_cb = e->on_error;
  Py_XINCREF(err_cb);
  if (ce_drop(e) < 0) { Py_XDECREF(err_cb); return -1; }
  if (err_cb && err_cb != Py_None) {
    PyObject *msg = PyUnicode_FromString(reason);
    if (!msg) { Py_DECREF(err_cb); return -1; }
    PyObject *r = PyObject_CallOneArg(err_cb, msg);
    Py_DECREF(msg);
    Py_DECREF(err_cb);
    if (!r) return -1;
    Py_DECREF(r);
  } else {
    Py_XDECREF(err_cb);
  }
  return 0;
}

static int ce_enter_time_wait(CEp *e, int64_t now) {
  if (e->state == ST_TIME_WAIT) return 0;
  int was_open = e->state == ST_ESTABLISHED || e->state == ST_CLOSING ||
                 e->state == ST_FIN_SENT;
  e->state = ST_TIME_WAIT;
  if (ce_cancel_ctl(e) < 0) return -1;
  if (cep_cancel_timer(e, &e->rto_timer) < 0) return -1;
  if (cep_cancel_timer(e, &e->idle_timer) < 0) return -1;
  /* schedule the final drop WITHOUT tracking a handle (Python twin
   * schedules self._drop unconditionally) */
  PyObject *tmp = NULL;
  if (cep_schedule(e, 2 * e->rto_ns, S_drop_fire, &tmp) < 0) return -1;
  Py_XDECREF(tmp);
  if (was_open && e->sink) return relay_conn_closed(e->sink);
  if (was_open && e->on_close && e->on_close != Py_None) {
    PyObject *tn = PyLong_FromLongLong(now);
    if (!tn) return -1;
    PyObject *r = PyObject_CallOneArg(e->on_close, tn);
    Py_DECREF(tn);
    if (!r) return -1;
    Py_DECREF(r);
  }
  return 0;
}

static int ce_send_fin(CEp *e, int64_t now) {
  e->fin_tries++;
  if (e->fin_tries > FIN_RETRIES_C) return ce_drop(e); /* orphan timeout */
  if (cep_emit(e, now, TK_FIN, 0, NULL, 0, 0, 0) < 0) return -1;
  int64_t mult = 1LL << (e->fin_tries - 1);
  if (mult > 64) mult = 64;
  return cep_schedule(e, e->rto_ns * mult, S_fin_fire, &e->ctl_timer);
}

static int ce_sender_drained(CEp *e, int64_t now) {
  if (e->peer_fin &&
      (e->state == ST_ESTABLISHED || e->state == ST_CLOSING)) {
    if (cep_emit(e, now, TK_FINACK, 0, NULL, 0, 0, 0) < 0) return -1;
    return ce_enter_time_wait(e, now);
  }
  if (e->state == ST_CLOSING) {
    e->state = ST_FIN_SENT;
    return ce_send_fin(e, now);
  }
  return 0;
}

static int ce_send_syn(CEp *e, int64_t now) {
  e->syn_tries++;
  if (e->syn_tries > SYN_RETRIES_C)
    return ce_reset(e, "connection timed out (ETIMEDOUT): SYN retries exhausted");
  int err;
  int64_t w = cep_window(e, &err);
  if (err) return -1;
  if (cep_emit(e, now, TK_SYN, 0, NULL, 0, 0, w) < 0) return -1;
  int64_t mult = 1LL << (e->syn_tries - 1);
  if (mult > 64) mult = 64;
  return cep_schedule(e, e->rto_ns * mult, S_syn_fire, &e->ctl_timer);
}

/* the unit-arrival dispatch (StreamEndpoint.handle_fields twin) */
static int ce_handle_fields(CEp *e, int64_t now, int k, int64_t nbytes,
                            PyObject *payload, int64_t seq) {
  int err;
  if (e->idle_timer) {
    /* any arrival proves the peer is alive (StreamEndpoint twin: the
     * rearm consumes one seq, exactly like _rearm_idle's schedule_in) */
    if (cep_cancel_timer(e, &e->idle_timer) < 0) return -1;
    if (cep_schedule(e, e->idle_timeout_ns, S_idle_fire,
                     &e->idle_timer) < 0)
      return -1;
  }
  if (k == TK_SYN) {
    if (e->state == ST_ESTABLISHED) { /* dup SYN: SYNACK was lost */
      e->adv_wnd = seq;
      int64_t w = cep_window(e, &err);
      if (err) return -1;
      return cep_emit(e, now, TK_SYNACK, 0, NULL, 0, 0, w);
    }
    return 0;
  }
  if (k == TK_SYNACK) {
    if (e->state == ST_SYN_SENT) {
      e->state = ST_ESTABLISHED;
      e->adv_wnd = seq;
      if (ce_cancel_ctl(e) < 0) return -1;
      if (e->on_connected && e->on_connected != Py_None) {
        PyObject *tn = PyLong_FromLongLong(now);
        if (!tn) return -1;
        PyObject *r = PyObject_CallOneArg(e->on_connected, tn);
        Py_DECREF(tn);
        if (!r) return -1;
        Py_DECREF(r);
      }
      return cs_pump(e, now);
    }
    return 0;
  }
  if (k == TK_DATA) {
    if (e->state == ST_CLOSED || e->state == ST_TIME_WAIT) return 0;
    cep_h(e)->d_sbytes_recv += nbytes;
    return cr_on_data(e, now, seq, nbytes, payload);
  }
  if (k == TK_ACK) {
    if (e->state == ST_CLOSED || e->state == ST_TIME_WAIT) return 0;
    return cs_on_ack(e, now, nbytes, seq, payload);
  }
  if (k == TK_FIN) {
    if (e->state == ST_SYN_SENT) {
      if (cep_emit(e, now, TK_FINACK, 0, NULL, 0, 0, 0) < 0) return -1;
      return ce_reset(e, "connection closed by peer");
    }
    if ((e->state == ST_ESTABLISHED || e->state == ST_CLOSING) &&
        (e->buffered > 0 || e->snd_nxt - e->snd_una > 0)) {
      e->peer_fin = 1; /* half-close: FINACK when drained */
      return 0;
    }
    if (cep_emit(e, now, TK_FINACK, 0, NULL, 0, 0, 0) < 0) return -1;
    if (e->state != ST_CLOSED) return ce_enter_time_wait(e, now);
    return 0;
  }
  if (k == TK_FINACK) {
    if (e->state == ST_FIN_SENT) {
      if (ce_cancel_ctl(e) < 0) return -1;
      if (e->sink) {
        if (ce_drop(e) < 0) return -1;
        return relay_conn_closed(e->sink);
      }
      PyObject *close_cb = e->on_close;
      Py_XINCREF(close_cb);
      if (ce_drop(e) < 0) { Py_XDECREF(close_cb); return -1; }
      if (close_cb && close_cb != Py_None) {
        PyObject *tn = PyLong_FromLongLong(now);
        if (!tn) { Py_DECREF(close_cb); return -1; }
        PyObject *r = PyObject_CallOneArg(close_cb, tn);
        Py_DECREF(tn);
        Py_DECREF(close_cb);
        if (!r) return -1;
        Py_DECREF(r);
      } else {
        Py_XDECREF(close_cb);
      }
    }
    return 0;
  }
  return 0;
}

/* ---- CEp Python surface ------------------------------------------------ */
static int CEp_traverse(CEp *e, visitproc visit, void *arg) {
  Py_VISIT(e->core);
  Py_VISIT(e->on_connected);
  Py_VISIT(e->on_data);
  Py_VISIT(e->on_drain);
  Py_VISIT(e->on_close);
  Py_VISIT(e->on_error);
  Py_VISIT(e->app_unread);
  Py_VISIT(e->tgen_cb);
  Py_VISIT(e->xsink);
  return 0;
}

static int CEp_clear_gc(CEp *e) {
  Py_CLEAR(e->core);
  Py_CLEAR(e->on_connected);
  Py_CLEAR(e->on_data);
  Py_CLEAR(e->on_drain);
  Py_CLEAR(e->on_close);
  Py_CLEAR(e->on_error);
  Py_CLEAR(e->app_unread);
  Py_CLEAR(e->tgen_cb);
  Py_CLEAR(e->xsink);
  return 0;
}

static void CEp_dealloc(CEp *e) {
  PyObject_GC_UnTrack(e);
  Py_XDECREF(e->core);
  Py_XDECREF(e->ctl_timer);
  Py_XDECREF(e->rto_timer);
  Py_XDECREF(e->idle_timer);
  for (int i = 0; i < e->sendbuf.count; i++)
    Py_XDECREF(((SQEnt *)ring_at(&e->sendbuf, i))->payload);
  for (int i = 0; i < e->rtx.count; i++)
    Py_XDECREF(((RtxEnt *)ring_at(&e->rtx, i))->payload);
  for (int i = 0; i < e->ooo.count; i++)
    Py_XDECREF(((RtxEnt *)ring_at(&e->ooo, i))->payload);
  free(e->sendbuf.buf);
  free(e->rtx.buf);
  free(e->ooo.buf);
  free(e->sacked.buf);
  free(e->rtx_done.buf);
  Py_XDECREF(e->app_unread);
  Py_XDECREF(e->on_connected);
  Py_XDECREF(e->on_data);
  Py_XDECREF(e->on_drain);
  Py_XDECREF(e->on_close);
  Py_XDECREF(e->on_error);
  Py_XDECREF(e->tgen_cb);
  Py_XDECREF(e->xsink);
  Py_TYPE(e)->tp_free((PyObject *)e);
}

/* app-side send (StreamEndpoint.send + StreamSender.queue twin).
   payload may be NULL (counted bytes); off slices a byte payload's tail.
   Returns accepted count, or -1 on error. */
static int64_t cs_send(CEp *e, int64_t now, int64_t nbytes,
                       PyObject *payload, int64_t off) {
  if (payload) nbytes = PyBytes_GET_SIZE(payload) - off;
  if (nbytes <= 0 || e->state == ST_CLOSING || e->state == ST_FIN_SENT ||
      e->state == ST_TIME_WAIT)
    return 0;
  int64_t room = e->send_buffer - e->buffered;
  int64_t accept = nbytes < room ? nbytes : (room > 0 ? room : 0);
  if (accept <= 0) return 0;
  SQEnt *q = ring_push(&e->sendbuf);
  if (!q) return -1;
  q->nbytes = accept;
  if (payload) {
    q->payload = PySequence_GetSlice(payload, off, off + accept);
    if (!q->payload) { e->sendbuf.count--; return -1; }
  } else {
    q->payload = NULL;
  }
  e->buffered += accept;
  if (cs_pump(e, now) < 0) return -1;
  cep_h(e)->d_sbytes_q += accept;
  return accept;
}

static PyObject *CEp_send(CEp *e, PyObject *args, PyObject *kw) {
  static char *kws[] = {"nbytes", "payload", NULL};
  long long nbytes = 0;
  PyObject *payload = Py_None;
  if (!PyArg_ParseTupleAndKeywords(args, kw, "|LO", kws, &nbytes, &payload))
    return NULL;
  int err;
  int64_t now = cep_now(e, &err);
  if (err) return NULL;
  int64_t accepted = cs_send(e, now, nbytes,
                             payload == Py_None ? NULL : payload, 0);
  if (accepted < 0) return NULL;
  return PyLong_FromLongLong(accepted);
}

static PyObject *CEp_close(CEp *e, PyObject *noarg) {
  (void)noarg;
  if (e->state == ST_CLOSED || e->state == ST_CLOSING ||
      e->state == ST_FIN_SENT || e->state == ST_TIME_WAIT)
    Py_RETURN_NONE;
  e->state = ST_CLOSING;
  int err;
  int64_t now = cep_now(e, &err);
  if (err) return NULL;
  if (cs_pump(e, now) < 0) return NULL;
  Py_RETURN_NONE;
}

static PyObject *CEp_connect(CEp *e, PyObject *noarg) {
  (void)noarg;
  e->state = ST_SYN_SENT;
  int err;
  int64_t now = cep_now(e, &err);
  if (err) return NULL;
  if (ce_send_syn(e, now) < 0) return NULL;
  Py_RETURN_NONE;
}

static PyObject *CEp_window(CEp *e, PyObject *noarg) {
  (void)noarg;
  int err;
  int64_t w = cep_window(e, &err);
  if (err) return NULL;
  return PyLong_FromLongLong(w);
}

static PyObject *CEp_flush_ack(CEp *e, PyObject *noarg) {
  (void)noarg;
  int err;
  e->last_wnd = cep_window(e, &err);
  if (err) return NULL;
  int64_t now = cep_now(e, &err);
  if (err) return NULL;
  PyObject *sp = cr_sack_payload(e, &err);
  if (err) return NULL;
  int r = cep_emit(e, now, TK_ACK, 0, sp, 0, e->rcv_nxt, e->last_wnd);
  Py_XDECREF(sp);
  if (r < 0) return NULL;
  Py_RETURN_NONE;
}

static PyObject *CEp_on_app_read(CEp *e, PyObject *noarg) {
  (void)noarg;
  int err;
  if (e->last_wnd < (e->recv_buffer >> 2) && e->state != ST_CLOSED &&
      e->state != ST_TIME_WAIT) {
    int64_t w = cep_window(e, &err);
    if (err) return NULL;
    if (w > e->last_wnd && cep_mark_ack(e) < 0) return NULL;
  }
  Py_RETURN_NONE;
}

static PyObject *CEp_handle_fields(CEp *e, PyObject *args) {
  long long k, nbytes, seq, now;
  PyObject *payload;
  if (!PyArg_ParseTuple(args, "LLOLL", &k, &nbytes, &payload, &seq, &now))
    return NULL;
  if (ce_handle_fields(e, now, (int)k, nbytes,
                       payload == Py_None ? NULL : payload, seq) < 0)
    return NULL;
  Py_RETURN_NONE;
}

static PyObject *CEp_emit(CEp *e, PyObject *args, PyObject *kw) {
  static char *kws[] = {"kind", "nbytes", "payload", "seq", "acked", "wnd",
                        NULL};
  long long kind, nbytes = 0, seq = 0, acked = 0, wnd = 0;
  PyObject *payload = Py_None;
  if (!PyArg_ParseTupleAndKeywords(args, kw, "L|LOLLL", kws, &kind,
                                   &nbytes, &payload, &seq, &acked, &wnd))
    return NULL;
  int err;
  int64_t now = cep_now(e, &err);
  if (err) return NULL;
  if (cep_emit(e, now, (int)kind, nbytes,
               payload == Py_None ? NULL : payload, seq, acked, wnd) < 0)
    return NULL;
  Py_RETURN_NONE;
}

/* timer entry points (scheduled on the host's Python event queue) */
static PyObject *CEp_rto_fire(CEp *e, PyObject *noarg) {
  (void)noarg;
  int err;
  int64_t now = cep_now(e, &err);
  if (err) return NULL;
  if (cs_on_rto(e, now) < 0) return NULL;
  Py_RETURN_NONE;
}

static PyObject *CEp_syn_fire(CEp *e, PyObject *noarg) {
  (void)noarg;
  if (e->state == ST_SYN_SENT) {
    int err;
    int64_t now = cep_now(e, &err);
    if (err) return NULL;
    if (ce_send_syn(e, now) < 0) return NULL;
  }
  Py_RETURN_NONE;
}

static PyObject *CEp_fin_fire(CEp *e, PyObject *noarg) {
  (void)noarg;
  if (e->state == ST_FIN_SENT) {
    int err;
    int64_t now = cep_now(e, &err);
    if (err) return NULL;
    if (ce_send_fin(e, now) < 0) return NULL;
  }
  Py_RETURN_NONE;
}

static PyObject *CEp_drop_fire(CEp *e, PyObject *noarg) {
  (void)noarg;
  if (ce_drop(e) < 0) return NULL;
  Py_RETURN_NONE;
}

static PyObject *CEp_idle_fire(CEp *e, PyObject *noarg) {
  /* StreamEndpoint._idle_expired twin */
  (void)noarg;
  Py_CLEAR(e->idle_timer);
  if (e->state == ST_CLOSED || e->state == ST_TIME_WAIT) Py_RETURN_NONE;
  if (e->core->faults_active) cep_h(e)->d_timeouts++;
  if (ce_reset(e, "connection timed out (ETIMEDOUT): idle timeout — no "
                  "traffic from peer") < 0)
    return NULL;
  Py_RETURN_NONE;
}

static PyObject *CEp_set_idle_timeout(CEp *e, PyObject *arg) {
  /* StreamEndpoint.set_idle_timeout twin: arm (or disarm with 0/None) */
  int64_t t = 0;
  if (arg != Py_None) {
    t = PyLong_AsLongLong(arg);
    if (t == -1 && PyErr_Occurred()) return NULL;
  }
  if (cep_cancel_timer(e, &e->idle_timer) < 0) return NULL;
  e->idle_timeout_ns = t > 0 ? t : 0;
  if (e->idle_timeout_ns &&
      cep_schedule(e, e->idle_timeout_ns, S_idle_fire, &e->idle_timer) < 0)
    return NULL;
  Py_RETURN_NONE;
}

/* Host.crash teardown hooks (faults.py): the crash loop duck-types
 * ep._cancel_ctl() / ep.sender._cancel_rto() — identical disarm
 * semantics to the Python endpoint's private methods */
static PyObject *CEp_cancel_ctl_m(CEp *e, PyObject *noarg) {
  (void)noarg;
  if (ce_cancel_ctl(e) < 0) return NULL;
  Py_RETURN_NONE;
}

static PyObject *CEp_cancel_rto_m(CEp *e, PyObject *noarg) {
  (void)noarg;
  if (cep_cancel_timer(e, &e->rto_timer) < 0) return NULL;
  Py_RETURN_NONE;
}

static PyObject *CEp_fingerprint(CEp *e, PyObject *noarg) {
  /* StreamEndpoint.fingerprint twin for the determinism sentinel: the
   * SAME 28 fields in the same order with the same Python types (bools
   * stay bools — checkpoint._feed encodes them differently from ints),
   * so digest streams are identical with the C engine on and off */
  (void)noarg;
  PyObject *sk = i64set_sorted_tuple(&e->sacked);
  if (!sk) return NULL;
  PyObject *rd = i64set_sorted_tuple(&e->rtx_done);
  if (!rd) { Py_DECREF(sk); return NULL; }
  return Py_BuildValue(
      "(iOiiOLLLLLLiLiiLLLLLiLLiLLNN)", e->state,
      e->initiator ? Py_True : Py_False, e->syn_tries, e->fin_tries,
      e->peer_fin ? Py_True : Py_False, (long long)e->snd_nxt,
      (long long)e->snd_una, (long long)e->cwnd, (long long)e->ssthresh,
      (long long)e->adv_wnd, (long long)e->buffered, e->retries,
      (long long)e->rto_backoff, e->dup_acks, e->loss_events,
      (long long)e->bytes_acked, (long long)e->rcv_nxt,
      (long long)e->ooo_bytes, (long long)e->bytes_received,
      (long long)e->last_wnd,
      /* PR 9: SACK scoreboard + congestion-control seam state */
      e->cc_kind, (long long)e->w_max, (long long)e->epoch_start,
      e->in_recovery ? 1 : 0, (long long)e->recover,
      (long long)e->sack_high, sk, rd);
}

/* opt-in surface for the models/tgen.py fast path; Python-plane
 * endpoints don't have these attrs, so the model falls back to its
 * closure implementation (getattr probe) */
static PyObject *CEp_tgen_serve(CEp *e, PyObject *cb) {
  e->tgen_mode = 1;
  Py_INCREF(cb);
  Py_XSETREF(e->tgen_cb, cb);
  Py_RETURN_NONE;
}

static PyObject *CEp_tgen_client(CEp *e, PyObject *args) {
  long long want;
  PyObject *cb;
  if (!PyArg_ParseTuple(args, "LO", &want, &cb)) return NULL;
  e->tgen_mode = 2;
  e->tgen_want = want;
  e->tgen_pending = 0;
  e->tgen_t_first = -1;
  Py_INCREF(cb);
  Py_XSETREF(e->tgen_cb, cb);
  Py_RETURN_NONE;
}

static PyObject *CEp_get_self(CEp *e, void *u) {
  (void)u;
  Py_INCREF(e);
  return (PyObject *)e;
}

#define CB_GETSET(name)                                       \
  static PyObject *CEp_get_##name(CEp *e, void *u) {          \
    (void)u;                                                  \
    PyObject *v = e->name ? e->name : Py_None;                \
    Py_INCREF(v);                                             \
    return v;                                                 \
  }                                                           \
  static int CEp_set_##name(CEp *e, PyObject *v, void *u) {   \
    (void)u;                                                  \
    Py_XINCREF(v);                                            \
    Py_XSETREF(e->name, v);                                   \
    return 0;                                                 \
  }
CB_GETSET(on_connected)
CB_GETSET(on_data)
CB_GETSET(on_drain)
CB_GETSET(on_close)
CB_GETSET(on_error)
CB_GETSET(app_unread)

#define I64_GETSET(name)                                      \
  static PyObject *CEp_get_##name(CEp *e, void *u) {          \
    (void)u;                                                  \
    return PyLong_FromLongLong(e->name);                      \
  }                                                           \
  static int CEp_set_##name(CEp *e, PyObject *v, void *u) {   \
    (void)u;                                                  \
    int64_t x = PyLong_AsLongLong(v);                         \
    if (x == -1 && PyErr_Occurred()) return -1;               \
    e->name = x;                                              \
    return 0;                                                 \
  }
I64_GETSET(adv_wnd)
I64_GETSET(buffered)
I64_GETSET(send_buffer)
I64_GETSET(recv_buffer)
I64_GETSET(bytes_acked)
I64_GETSET(bytes_received)
I64_GETSET(rcv_nxt)
I64_GETSET(snd_una)
I64_GETSET(snd_nxt)
I64_GETSET(cwnd)
I64_GETSET(rto_ns)
/* telemetry samplers (shadow_tpu/telemetry/collector.py) read the same
 * sender-state fields the Python twin exposes on StreamSender */
I64_GETSET(ssthresh)
I64_GETSET(rto_backoff)

static PyObject *CEp_get_retries(CEp *e, void *u) {
  (void)u;
  return PyLong_FromLong(e->retries);
}

static PyObject *CEp_get_tgen_t_first(CEp *e, void *u) {
  (void)u;
  return PyLong_FromLongLong(e->tgen_t_first);
}

static PyObject *CEp_get_state(CEp *e, void *u) {
  (void)u;
  return PyLong_FromLong(e->state);
}
static int CEp_set_state(CEp *e, PyObject *v, void *u) {
  (void)u;
  long x = PyLong_AsLong(v);
  if (x == -1 && PyErr_Occurred()) return -1;
  e->state = (int)x;
  return 0;
}
static PyObject *CEp_get_local_port(CEp *e, void *u) {
  (void)u;
  return PyLong_FromLong(e->local_port);
}
static PyObject *CEp_get_remote_host(CEp *e, void *u) {
  (void)u;
  return PyLong_FromLong(e->remote_host);
}
static PyObject *CEp_get_remote_port(CEp *e, void *u) {
  (void)u;
  return PyLong_FromLong(e->remote_port);
}
static PyObject *CEp_get_loss_events(CEp *e, void *u) {
  (void)u;
  return PyLong_FromLong(e->loss_events);
}

static PyGetSetDef CEp_getset[] = {
    {"sender", (getter)CEp_get_self, NULL, "sender half (self)", NULL},
    {"receiver", (getter)CEp_get_self, NULL, "receiver half (self)", NULL},
    {"state", (getter)CEp_get_state, (setter)CEp_set_state, NULL, NULL},
    {"on_connected", (getter)CEp_get_on_connected,
     (setter)CEp_set_on_connected, NULL, NULL},
    {"on_data", (getter)CEp_get_on_data, (setter)CEp_set_on_data, NULL,
     NULL},
    {"on_drain", (getter)CEp_get_on_drain, (setter)CEp_set_on_drain, NULL,
     NULL},
    {"on_close", (getter)CEp_get_on_close, (setter)CEp_set_on_close, NULL,
     NULL},
    {"on_error", (getter)CEp_get_on_error, (setter)CEp_set_on_error, NULL,
     NULL},
    {"app_unread", (getter)CEp_get_app_unread, (setter)CEp_set_app_unread,
     NULL, NULL},
    {"adv_wnd", (getter)CEp_get_adv_wnd, (setter)CEp_set_adv_wnd, NULL,
     NULL},
    {"buffered", (getter)CEp_get_buffered, (setter)CEp_set_buffered, NULL,
     NULL},
    {"send_buffer", (getter)CEp_get_send_buffer,
     (setter)CEp_set_send_buffer, NULL, NULL},
    {"recv_buffer", (getter)CEp_get_recv_buffer,
     (setter)CEp_set_recv_buffer, NULL, NULL},
    {"bytes_acked", (getter)CEp_get_bytes_acked,
     (setter)CEp_set_bytes_acked, NULL, NULL},
    {"bytes_received", (getter)CEp_get_bytes_received,
     (setter)CEp_set_bytes_received, NULL, NULL},
    {"rcv_nxt", (getter)CEp_get_rcv_nxt, (setter)CEp_set_rcv_nxt, NULL,
     NULL},
    {"snd_una", (getter)CEp_get_snd_una, (setter)CEp_set_snd_una, NULL,
     NULL},
    {"snd_nxt", (getter)CEp_get_snd_nxt, (setter)CEp_set_snd_nxt, NULL,
     NULL},
    {"cwnd", (getter)CEp_get_cwnd, (setter)CEp_set_cwnd, NULL, NULL},
    {"rto_ns", (getter)CEp_get_rto_ns, (setter)CEp_set_rto_ns, NULL, NULL},
    {"local_port", (getter)CEp_get_local_port, NULL, NULL, NULL},
    {"remote_host", (getter)CEp_get_remote_host, NULL, NULL, NULL},
    {"remote_port", (getter)CEp_get_remote_port, NULL, NULL, NULL},
    {"loss_events", (getter)CEp_get_loss_events, NULL, NULL, NULL},
    {"ssthresh", (getter)CEp_get_ssthresh, (setter)CEp_set_ssthresh, NULL,
     NULL},
    {"rto_backoff", (getter)CEp_get_rto_backoff,
     (setter)CEp_set_rto_backoff, NULL, NULL},
    {"retries", (getter)CEp_get_retries, NULL, NULL, NULL},
    {"tgen_t_first", (getter)CEp_get_tgen_t_first, NULL, NULL, NULL},
    {NULL, NULL, NULL, NULL, NULL}};

static PyObject *CEp_export_state(CEp *e, PyObject *noarg);
static PyObject *CEp_restore_state(CEp *e, PyObject *state);

static PyMethodDef CEp_methods[] = {
    {"send", (PyCFunction)CEp_send, METH_VARARGS | METH_KEYWORDS, NULL},
    {"close", (PyCFunction)CEp_close, METH_NOARGS, NULL},
    {"connect", (PyCFunction)CEp_connect, METH_NOARGS, NULL},
    {"window", (PyCFunction)CEp_window, METH_NOARGS, NULL},
    {"flush_ack", (PyCFunction)CEp_flush_ack, METH_NOARGS, NULL},
    {"on_app_read", (PyCFunction)CEp_on_app_read, METH_NOARGS, NULL},
    {"handle_fields", (PyCFunction)CEp_handle_fields, METH_VARARGS, NULL},
    {"emit", (PyCFunction)CEp_emit, METH_VARARGS | METH_KEYWORDS, NULL},
    {"tgen_serve", (PyCFunction)CEp_tgen_serve, METH_O,
     "(on_request) -> None  enable the C TGenServer data path"},
    {"tgen_client", (PyCFunction)CEp_tgen_client, METH_VARARGS,
     "(want, on_complete) -> None  enable the C TGenClient data path"},
    {"_rto_fire", (PyCFunction)CEp_rto_fire, METH_NOARGS, NULL},
    {"_syn_fire", (PyCFunction)CEp_syn_fire, METH_NOARGS, NULL},
    {"_fin_fire", (PyCFunction)CEp_fin_fire, METH_NOARGS, NULL},
    {"_drop_fire", (PyCFunction)CEp_drop_fire, METH_NOARGS, NULL},
    {"_idle_fire", (PyCFunction)CEp_idle_fire, METH_NOARGS, NULL},
    {"set_idle_timeout", (PyCFunction)CEp_set_idle_timeout, METH_O,
     "arm (or disarm with 0/None) the idle timeout (transport.py twin)"},
    {"_cancel_ctl", (PyCFunction)CEp_cancel_ctl_m, METH_NOARGS, NULL},
    {"_cancel_rto", (PyCFunction)CEp_cancel_rto_m, METH_NOARGS, NULL},
    {"fingerprint", (PyCFunction)CEp_fingerprint, METH_NOARGS,
     "StreamEndpoint.fingerprint twin (determinism sentinel)"},
    {"_export_state", (PyCFunction)CEp_export_state, METH_NOARGS,
     "checkpoint export: full protocol state as a plain tuple"},
    {"_restore_state", (PyCFunction)CEp_restore_state, METH_O,
     "checkpoint restore: fill an orphan endpoint from _export_state"},
    {NULL, NULL, 0, NULL}};

static PyTypeObject CEp_Type = {
    PyVarObject_HEAD_INIT(NULL, 0).tp_name = "_colcore.Endpoint",
    .tp_basicsize = sizeof(CEp),
    .tp_dealloc = (destructor)CEp_dealloc,
    /* GC-tracked: the app callbacks ALWAYS form cycles through the
     * endpoint (app holds ep, ep.on_data closes over app) — without
     * traverse/clear every churned connection would leak (review r4) */
    .tp_flags = Py_TPFLAGS_DEFAULT | Py_TPFLAGS_HAVE_GC,
    .tp_traverse = (traverseproc)CEp_traverse,
    .tp_clear = (inquiry)CEp_clear_gc,
    .tp_methods = CEp_methods,
    .tp_getset = CEp_getset,
    .tp_free = PyObject_GC_Del,
    .tp_doc = "C stream endpoint (network/transport.py twin)",
};

/* factory shared by Python (Host._make_endpoint) and the C SYN accept */
static CEp *cep_new(CoreObject *c, int hid, int lport, int rhost, int rport,
                    int initiator, int64_t sbuf, int64_t rbuf, int cc) {
  CEp *e = PyObject_GC_New(CEp, &CEp_Type);
  if (!e) return NULL;
  memset(((char *)e) + sizeof(PyObject), 0, sizeof(CEp) - sizeof(PyObject));
  Py_INCREF(c);
  e->core = c;
  e->hid = hid;
  e->local_port = lport;
  e->remote_host = rhost;
  e->remote_port = rport;
  e->initiator = initiator;
  e->state = ST_CLOSED;
  e->cwnd = INIT_CWND_C;
  e->ssthresh = 1LL << 62;
  e->adv_wnd = INIT_CWND_C;
  e->rto_backoff = 1;
  e->tgen_t_first = -1;
  e->cc_kind = cc;
  e->send_buffer = sbuf;
  e->recv_buffer = rbuf;
  e->last_wnd = rbuf;
  e->chunk = c->unit_chunk;
  e->sacked.esz = sizeof(int64_t);
  e->rtx_done.esz = sizeof(int64_t);
  e->sendbuf.esz = sizeof(SQEnt);
  e->rtx.esz = sizeof(RtxEnt);
  e->ooo.esz = sizeof(RtxEnt);
  int32_t sn = c->hostnode[hid], dn = c->hostnode[rhost];
  int64_t rtt = c->lat[(int64_t)sn * c->G + dn] +
                c->lat[(int64_t)dn * c->G + sn];
  /* cap BEFORE doubling: rtt can be 2x INF_I64 on a cut path and 2*rtt
   * would overflow int64 (the Python twin computes in big ints) */
  e->rto_ns = rtt > RTO_MAX_NS_C / 2 ? RTO_MAX_NS_C
              : (2 * rtt > RTO_MIN_NS_C ? 2 * rtt : RTO_MIN_NS_C);
  PyObject_GC_Track((PyObject *)e);
  return e;
}

static PyObject *Core_make_endpoint(CoreObject *c, PyObject *args) {
  long long hid, lport, rhost, rport, sbuf, rbuf, cc = 0;
  int initiator;
  if (!PyArg_ParseTuple(args, "LLLLpLL|L", &hid, &lport, &rhost, &rport,
                        &initiator, &sbuf, &rbuf, &cc))
    return NULL;
  if (hid < 0 || hid >= c->H || rhost < 0 || rhost >= c->H) {
    PyErr_SetString(PyExc_ValueError, "host id out of range");
    return NULL;
  }
  return (PyObject *)cep_new(c, (int)hid, (int)lport, (int)rhost,
                             (int)rport, initiator, sbuf, rbuf, (int)cc);
}

/* the barrier's coalesced-ack flush loop (colplane._barrier_round twin):
 * `arg` is the id-sorted ack_hosts list; each host's _ack_eps snapshot
 * flushes one cumulative ACK per open endpoint and the dict clears IN
 * PLACE (identity-stable — cep_mark_ack caches it). */
static PyObject *Core_flush_acks(CoreObject *c, PyObject *arg) {
  if (!PyList_Check(arg)) {
    PyErr_SetString(PyExc_TypeError, "flush_acks expects a list of hosts");
    return NULL;
  }
  for (Py_ssize_t i = 0; i < PyList_GET_SIZE(arg); i++) {
    PyObject *host = PyList_GET_ITEM(arg, i);
    int64_t hid;
    if (attr_i64(host, S_id, &hid) < 0) return NULL;
    if (hid < 0 || hid >= c->H) {
      PyErr_SetString(PyExc_ValueError, "host id out of range");
      return NULL;
    }
    CHost *h = &c->hs[hid];
    if (PyDict_GET_SIZE(h->ack_eps) == 0) continue;
    PyObject *keys = PyDict_Keys(h->ack_eps); /* insertion-order snapshot */
    if (!keys) return NULL;
    PyDict_Clear(h->ack_eps);
    int64_t now = 0;
    int have_now = 0;
    for (Py_ssize_t j = 0; j < PyList_GET_SIZE(keys); j++) {
      PyObject *ep = PyList_GET_ITEM(keys, j);
      if (Py_TYPE(ep) == &CEp_Type) {
        CEp *e = (CEp *)ep;
        if (e->state == ST_CLOSED) continue;
        int err;
        e->last_wnd = cep_window(e, &err);
        if (err) { Py_DECREF(keys); return NULL; }
        if (!have_now) { /* one clock read per host: flushes never move it */
          now = cep_now(e, &err);
          if (err) { Py_DECREF(keys); return NULL; }
          have_now = 1;
        }
        PyObject *sp = cr_sack_payload(e, &err);
        if (err) { Py_DECREF(keys); return NULL; }
        int remit = cep_emit(e, now, TK_ACK, 0, sp, 0, e->rcv_nxt,
                             e->last_wnd);
        Py_XDECREF(sp);
        if (remit < 0) {
          Py_DECREF(keys);
          return NULL;
        }
      } else {
        /* pcap-host Python endpoint: the twin's attribute path */
        PyObject *st = PyObject_GetAttrString(ep, "state");
        if (!st) { Py_DECREF(keys); return NULL; }
        long sv = PyLong_AsLong(st);
        Py_DECREF(st);
        if (sv == -1 && PyErr_Occurred()) { Py_DECREF(keys); return NULL; }
        if (sv == 0) continue; /* CLOSED */
        PyObject *recv = PyObject_GetAttrString(ep, "receiver");
        PyObject *r = recv
            ? PyObject_CallMethod(recv, "flush_ack", NULL) : NULL;
        Py_XDECREF(recv);
        if (!r) { Py_DECREF(keys); return NULL; }
        Py_DECREF(r);
      }
    }
    Py_DECREF(keys);
  }
  Py_RETURN_NONE;
}

static PyObject *Core_run_round(CoreObject *c, PyObject *args) {
  long long end_ll;
  if (!PyArg_ParseTuple(args, "L", &end_ll)) return NULL;
  int64_t end = end_ll;
  if (!c->active) {
    PyErr_SetString(PyExc_RuntimeError, "bind_active() not called");
    return NULL;
  }
  /* sorted active host ids (host-id execution order). The snapshot is
   * CACHED across rounds: membership only shrinks inside this function
   * (which updates the cache in place) and only grows elsewhere, so a
   * set-size match proves the cache is exact and the per-round
   * iterate + qsort — the dominant cost at 10k mostly-parked hosts —
   * is skipped. */
  TM0(6);
  if (act_refresh(c) < 0) return NULL;
  TM1(6);
  tm_cnt[7] += c->act_n;
  int64_t executed = 0;
  int64_t *ids = c->act_ids;
  int64_t k = c->act_n;
  int64_t w = 0; /* write index: survivors stay, discards compact away */
  int64_t i = 0;
  for (; i < k; i++) {
    int64_t hid = ids[i];
    if (hid < 0 || hid >= c->H) continue;
    CHost *h = &c->hs[hid];
    int has_inbox = h->py_mode ? 0 : (h->inbox_n > 0);
    Py_ssize_t hn = PyList_GET_SIZE(h->heap);
    int heap_due = 0;
    if (hn) {
      /* owned-root cache: same object at heap[0] => same (conservative)
       * head time; most parked hosts cost three pointer reads here */
      PyObject *head = PyList_GET_ITEM(h->heap, 0);
      if (head != h->head_cache) {
        Py_INCREF(head);
        Py_XSETREF(h->head_cache, head);
        h->head_time = tup_i64(head, 0);
      }
      heap_due = h->head_time < end; /* conservative (cancelled ok) */
    }
    if (h->py_mode) {
      /* pcap hosts etc.: the Python run_events consumes _inbox lists */
      PyObject *ib = PyObject_GetAttr(h->host, S_inbox);
      int has_py_inbox = ib && ib != Py_None;
      Py_XDECREF(ib);
      if (!has_py_inbox && !heap_due) {
        if (!hn) {
          if (PySet_Discard(c->active, h->id_obj) < 0) goto fail;
          continue; /* compacted out of the snapshot */
        }
        ids[w++] = hid;
        continue;
      }
      PyObject *r = PyObject_CallMethodObjArgs(
          h->host, S_run_events, PyTuple_GET_ITEM(args, 0), NULL);
      if (!r) goto fail;
      executed += PyLong_AsLongLong(r);
      Py_DECREF(r);
      if (PyErr_Occurred()) goto fail;
    } else if (has_inbox || heap_due) {
      int64_t n = run_host_c(c, h, (int)hid, end);
      if (n < 0) goto fail;
      executed += n;
    }
    if (PyList_GET_SIZE(h->heap) == 0) {
      if (PySet_Discard(c->active, h->id_obj) < 0) goto fail;
    } else {
      ids[w++] = hid;
    }
  }
  c->act_n = w;
  return PyLong_FromLongLong(executed);
fail:
  /* keep the untouched tail so the cache still mirrors the set */
  for (; i < k; i++) ids[w++] = ids[i];
  c->act_n = w;
  return NULL;
}


/* ---- stream row dispatch (Host.dispatch_row / _deliver_row twin) ------- */
static int dispatch_stream(CoreObject *c, CHost *h, int hid, IRow *ir,
                           int64_t *now, int *now_dirty) {
  int k = ir->kind;
  PyObject *pl = ir->payload;
  /* data-plane row: clock + ingress charge, then deliver. The clock
   * attr syncs up front — endpoint handlers arm timers via
   * host.schedule_in, which reads host._now. */
  if (ir->t > *now) { *now = ir->t; *now_dirty = 1; }
  if (*now_dirty) {
    if (attr_set_i64(h->host, S_now, *now) < 0) return -1;
    *now_dirty = 0;
  }
  if (ir->t >= c->bootstrap_end) {
    if (c->tokens_down[hid] >= ir->size) {
      c->tokens_down[hid] -= ir->size;
    } else {
      PyObject *dl = PyObject_GetAttr(h->host, S_ingress_deferred_rows);
      if (!dl) return -1;
      PyObject *row = irow_tuple(h, ir, hid);
      if (!row) { Py_DECREF(dl); return -1; }
      int r = PyList_Append(dl, row);
      Py_DECREF(row);
      Py_DECREF(dl);
      if (r < 0) return -1;
      if (PySet_Add(c->deferred, h->host) < 0) return -1;
      return 0;
    }
  }
  h->d_delivered++;
  PyObject *key = Py_BuildValue("(iii)", ir->bport, ir->peer, ir->aport);
  if (!key) return -1;
  PyObject *ep = PyDict_GetItem(h->conns, key);
  if (!ep) {
    if (k != TK_SYN) {
      Py_DECREF(key);
      h->d_unroutable++;
      return 0;
    }
    PyObject *pk = PyLong_FromLong(ir->bport);
    if (!pk) { Py_DECREF(key); return -1; }
    PyObject *on_accept = PyDict_GetItem(h->listeners, pk);
    Py_DECREF(pk);
    if (!on_accept) {
      Py_DECREF(key);
      h->d_unroutable++;
      return 0;
    }
    CEp *ne = cep_new(c, hid, ir->bport, ir->peer, ir->aport, 0,
                      c->sock_sbuf, c->sock_rbuf, h->cc_kind);
    if (!ne) { Py_DECREF(key); return -1; }
    ne->state = ST_ESTABLISHED;
    ne->adv_wnd = ir->seq; /* client window rides the SYN */
    int rset = PyDict_SetItem(h->conns, key, (PyObject *)ne);
    Py_DECREF(key);
    if (rset < 0) { Py_DECREF(ne); return -1; }
    int err;
    int64_t w = cep_window(ne, &err);
    if (err) { Py_DECREF(ne); return -1; }
    if (cep_emit(ne, *now, TK_SYNACK, 0, NULL, 0, 0, w) < 0) {
      Py_DECREF(ne);
      return -1;
    }
    /* on_accept(ep, t) — Python app callback */
    if (*now_dirty) {
      if (attr_set_i64(h->host, S_now, *now) < 0) { Py_DECREF(ne); return -1; }
      *now_dirty = 0;
    }
    PyObject *tn = PyLong_FromLongLong(*now);
    if (!tn) { Py_DECREF(ne); return -1; }
    PyObject *r = PyObject_CallFunctionObjArgs(on_accept, (PyObject *)ne,
                                               tn, NULL);
    Py_DECREF(tn);
    Py_DECREF(ne);
    if (!r) return -1;
    Py_DECREF(r);
    if (attr_i64(h->host, S_now, now) < 0) return -1;
    return 0;
  }
  Py_DECREF(key);
  if (Py_TYPE(ep) == &CEp_Type)
    return ce_handle_fields((CEp *)ep, *now, k, ir->nbytes, pl, ir->seq);
  /* Python endpoint on a C-dispatched host (shouldn't happen in
   * practice, but stay correct): sync the clock and delegate */
  if (*now_dirty) {
    if (attr_set_i64(h->host, S_now, *now) < 0) return -1;
    *now_dirty = 0;
  }
  PyObject *r = PyObject_CallMethod(ep, "handle_fields", "(LLOLL)",
                                    (long long)k, (long long)ir->nbytes,
                                    pl ? pl : Py_None, (long long)ir->seq,
                                    (long long)*now);
  if (!r) return -1;
  Py_DECREF(r);
  if (attr_i64(h->host, S_now, now) < 0) return -1;
  return 0;
}

/* ======================================================================
 * C tor-relay data path (models/tor.py TorRelay twin for the hot flow).
 *
 * The plain relay's steady state is: framed cells arrive on one C
 * endpoint, the circuit table maps (conn, circ) to the spliced peer,
 * and the cell/body forwards out the peer connection — all here, zero
 * Python. The control plane stays Python via one callback (on_ctrl):
 * EXTEND at the circuit head (opens a new connection through the
 * simulated network) — everything else (CREATE/CREATED handshakes,
 * forwarding, teardown cascades, DATA headers, counted bodies) is C.
 * Exits (TorExit) keep the full Python model. Bit-identity with the
 * Python relay is asserted by the colcore A/B suite on the tor config.
 * ====================================================================== */

#define TCELL_HDR 12
#define TC_CREATE 0
#define TC_CREATED 1
#define TC_EXTEND 2
#define TC_EXTENDED 3
#define TC_BEGIN 4
#define TC_DATA 6
#define TC_END 7

typedef struct { PyObject *payload; int64_t a; } PendEnt;
/* payload != NULL: byte frame, a = send offset; NULL: counted, a = left */

typedef struct CRelayConn {
  struct CRelayObj *relay; /* borrowed: relay owns conns[] */
  CEp *ep;                 /* owned */
  int cid;
  int close_after_drain;
  /* re-entrancy guard: a teardown cascade reached from inside this
   * conn's own feed/pump (peer_fin unwinding) must not free it while
   * its frames are on the C stack */
  int busy, dead;
  /* FrameReader state */
  char *buf;
  int64_t buf_len, buf_cap;
  int64_t body_left;
  int body_circ;
  Ring pend; /* PendEnt */
} CRelayConn;

typedef struct CRelayObj {
  PyObject_HEAD
  CoreObject *core; /* owned */
  int hid;
  PyObject *on_ctrl; /* Python callable(cid, ctype, circ, payload) */
  CRelayConn **conns;
  int nconns, conns_cap;
  /* circuit table: open addressing, key = (cid<<32)|circ (+1 so 0 =
   * empty), val = (ncid<<32)|ncirc */
  uint64_t *tk, *tv, *ts; /* keys, values, insertion seq (dict order) */
  uint64_t tseq;
  int tcap, tcount;
  int next_circ;
  int exit_mode; /* BEGIN at the circuit endpoint reaches on_ctrl */
  int64_t cells_relayed, bytes_relayed;
} CRelayObj;

static PyTypeObject CRelay_Type;

/* -- circuit table ------------------------------------------------------- */
static int rtab_grow(CRelayObj *r) {
  int ncap = r->tcap ? r->tcap * 2 : 64;
  uint64_t *nk = calloc((size_t)ncap, sizeof(uint64_t));
  uint64_t *nv = malloc((size_t)ncap * sizeof(uint64_t));
  uint64_t *ns = malloc((size_t)ncap * sizeof(uint64_t));
  if (!nk || !nv || !ns) {
    free(nk); free(nv); free(ns);
    PyErr_NoMemory();
    return -1;
  }
  for (int i = 0; i < r->tcap; i++) {
    if (!r->tk[i]) continue;
    uint64_t h = r->tk[i] * 0x9E3779B97F4A7C15ULL;
    int j = (int)(h & (uint64_t)(ncap - 1));
    while (nk[j]) j = (j + 1) & (ncap - 1);
    nk[j] = r->tk[i];
    nv[j] = r->tv[i];
    ns[j] = r->ts[i];
  }
  free(r->tk);
  free(r->tv);
  free(r->ts);
  r->tk = nk;
  r->tv = nv;
  r->ts = ns;
  r->tcap = ncap;
  return 0;
}

static inline uint64_t rtab_key(int cid, int circ) {
  return (((uint64_t)(uint32_t)cid << 32) | (uint32_t)circ) + 1;
}

static int rtab_get(CRelayObj *r, int cid, int circ, int *ncid, int *ncirc) {
  if (!r->tcap) return 0;
  uint64_t k = rtab_key(cid, circ);
  uint64_t h = k * 0x9E3779B97F4A7C15ULL;
  int i = (int)(h & (uint64_t)(r->tcap - 1));
  while (r->tk[i]) {
    if (r->tk[i] == k) {
      *ncid = (int)(r->tv[i] >> 32);
      *ncirc = (int)(uint32_t)r->tv[i];
      return 1;
    }
    i = (i + 1) & (r->tcap - 1);
  }
  return 0;
}

static int rtab_put(CRelayObj *r, int cid, int circ, int ncid, int ncirc) {
  if (r->tcount * 10 >= r->tcap * 7 && rtab_grow(r) < 0) return -1;
  uint64_t k = rtab_key(cid, circ);
  uint64_t h = k * 0x9E3779B97F4A7C15ULL;
  int i = (int)(h & (uint64_t)(r->tcap - 1));
  while (r->tk[i] && r->tk[i] != k) i = (i + 1) & (r->tcap - 1);
  if (!r->tk[i]) {
    r->tcount++;
    r->ts[i] = r->tseq++; /* dict insertion order; overwrite keeps it */
  }
  r->tk[i] = k;
  r->tv[i] = ((uint64_t)(uint32_t)ncid << 32) | (uint32_t)ncirc;
  return 0;
}

/* -- frames -------------------------------------------------------------- */
static PyObject *build_cell(int ctype, int circ, const char *payload,
                            Py_ssize_t plen);

/* a DATA header announcing `body_len` counted bytes (the len field
 * describes the FOLLOWING body, not an inline payload) */
static PyObject *build_data_hdr(int circ, int64_t body_len) {
  PyObject *hdr = build_cell(TC_DATA, circ, NULL, 0);
  if (!hdr) return NULL;
  char *hp = PyBytes_AS_STRING(hdr);
  hp[3] = (char)((body_len >> 8) & 0xFF);
  hp[4] = (char)(body_len & 0xFF);
  return hdr;
}

static PyObject *build_cell(int ctype, int circ, const char *payload,
                            Py_ssize_t plen) {
  PyObject *b = PyBytes_FromStringAndSize(NULL, TCELL_HDR + plen);
  if (!b) return NULL;
  char *p = PyBytes_AS_STRING(b);
  memset(p, 0, TCELL_HDR);
  p[0] = (char)ctype;
  p[1] = (char)((circ >> 8) & 0xFF);
  p[2] = (char)(circ & 0xFF);
  p[3] = (char)(((uint64_t)plen >> 8) & 0xFF);
  p[4] = (char)((uint64_t)plen & 0xFF);
  if (plen) memcpy(p + TCELL_HDR, payload, (size_t)plen);
  return b;
}

/* -- pending write queue (models/tor.py _Conn twin) ---------------------- */
/* graceful-close idiom shared by CEp_close and the relay teardown
 * paths: no-op unless the endpoint is in an open state */
static int cep_begin_close(CEp *e, int64_t now) {
  if (e->state == ST_CLOSED || e->state == ST_CLOSING ||
      e->state == ST_FIN_SENT || e->state == ST_TIME_WAIT)
    return 0;
  e->state = ST_CLOSING;
  return cs_pump(e, now);
}

static void relay_free_conn(CRelayConn *rc) {
  free(rc->buf);
  for (int i = 0; i < rc->pend.count; i++)
    Py_XDECREF(((PendEnt *)ring_at(&rc->pend, i))->payload);
  free(rc->pend.buf);
  Py_DECREF(rc->ep);
  free(rc);
}

/* detach a conn from its relay; honors the busy guard (an on-stack
 * feed/pump frame frees it at exit instead) */
static void relay_detach_conn(CRelayObj *r, int cid) {
  CRelayConn *rc = r->conns[cid];
  if (!rc) return;
  r->conns[cid] = NULL;
  rc->ep->sink = NULL;
  if (rc->busy)
    rc->dead = 1;
  else
    relay_free_conn(rc);
}

static int relay_pump_conn(CRelayConn *rc, int64_t now) {
  int rcod = 0;
  rc->busy++;
  while (!rc->dead && rc->pend.count) {
    PendEnt *head = ring_at(&rc->pend, 0);
    int64_t sent;
    int done;
    if (head->payload) {
      sent = cs_send(rc->ep, now, 0, head->payload, head->a);
      if (sent < 0) { rcod = -1; goto out; }
      if (rc->dead) goto out; /* send unwound into our own teardown */
      head->a += sent;
      done = head->a >= PyBytes_GET_SIZE(head->payload);
    } else {
      sent = cs_send(rc->ep, now, head->a, NULL, 0);
      if (sent < 0) { rcod = -1; goto out; }
      if (rc->dead) goto out;
      head->a -= sent;
      done = head->a <= 0;
    }
    if (done) {
      Py_XDECREF(head->payload);
      ring_popleft(&rc->pend);
    }
    if (sent == 0 && !done) goto out; /* buffer full; drain resumes */
  }
out:
  if (--rc->busy == 0 && rc->dead) { relay_free_conn(rc); return rcod; }
  return rcod;
}

/* the DRAIN entry point (ack freed buffer space): pump, then act on a
 * deferred close — the Python twin's close_when_drained only closes
 * from a subsequent on_drain, never from the write path's own pump */
static int relay_drain(CRelayConn *rc, int64_t now) {
  rc->busy++;
  int rcod = relay_pump_conn(rc, now);
  if (rcod == 0 && !rc->dead && rc->close_after_drain &&
      rc->pend.count == 0) {
    rc->close_after_drain = 0;
    rcod = cep_begin_close(rc->ep, now);
  }
  if (--rc->busy == 0 && rc->dead) relay_free_conn(rc);
  return rcod;
}

static int relay_write(CRelayConn *rc, int64_t now, PyObject *frame) {
  PendEnt *p = ring_push(&rc->pend);
  if (!p) { Py_DECREF(frame); return -1; }
  p->payload = frame; /* steals */
  p->a = 0;
  return relay_pump_conn(rc, now);
}

static int relay_write_counted(CRelayConn *rc, int64_t now, int64_t n) {
  PendEnt *p = ring_push(&rc->pend);
  if (!p) return -1;
  p->payload = NULL;
  p->a = n;
  return relay_pump_conn(rc, now);
}

/* -- the hot feed (FrameReader + TorRelay forwarding twin) --------------- */
static int relay_on_cell(CRelayObj *r, CRelayConn *rc, int64_t now,
                         int ctype, int circ, const char *pl,
                         Py_ssize_t plen) {
  if (ctype == TC_CREATE) {
    PyObject *f = build_cell(TC_CREATED, circ, NULL, 0);
    if (!f) return -1;
    return relay_write(rc, now, f);
  }
  int ncid, ncirc;
  int hit = rtab_get(r, rc->cid, circ, &ncid, &ncirc);
  if (ctype == TC_CREATED) {
    if (hit && r->conns[ncid]) {
      PyObject *f = build_cell(TC_EXTENDED, ncirc, NULL, 0);
      if (!f) return -1;
      return relay_write(r->conns[ncid], now, f);
    }
    return 0;
  }
  if ((ctype == TC_EXTEND || (r->exit_mode && ctype == TC_BEGIN))
      && !hit) {
    /* circuit head (EXTEND) or exit termination (BEGIN): the control
     * plane — connecting through the simulated network — is Python's */
    PyObject *plo = PyBytes_FromStringAndSize(pl, plen);
    if (!plo) return -1;
    PyObject *res = PyObject_CallFunction(r->on_ctrl, "(iiiO)", rc->cid,
                                          ctype, circ, plo);
    Py_DECREF(plo);
    if (!res) return -1;
    Py_DECREF(res);
    return 0;
  }
  if (!hit || !r->conns[ncid]) return 0; /* no route: drop (twin) */
  r->cells_relayed++;
  PyObject *f = build_cell(ctype, ncirc, pl, plen);
  if (!f) return -1;
  return relay_write(r->conns[ncid], now, f);
}

static int relay_feed(CRelayConn *rc, int64_t now, int64_t nbytes,
                      PyObject *payload) {
  CRelayObj *r = rc->relay;
  if (rc->body_left > 0 && (!payload || payload == Py_None)) {
    int64_t take = nbytes < rc->body_left ? nbytes : rc->body_left;
    rc->body_left -= take;
    int ncid, ncirc;
    if (rtab_get(r, rc->cid, rc->body_circ, &ncid, &ncirc) &&
        r->conns[ncid]) {
      r->bytes_relayed += take;
      rc->busy++;
      int w = relay_write_counted(r->conns[ncid], now, take);
      if (--rc->busy == 0 && rc->dead) { relay_free_conn(rc); return w; }
      if (w < 0 || rc->dead) return w;
    }
    if (nbytes > take) {
      PyErr_SetString(PyExc_ValueError,
                      "framing error: stray counted bytes");
      return -1;
    }
    return 0;
  }
  if (!payload || payload == Py_None) {
    PyErr_SetString(PyExc_ValueError,
                    "framing error: counted bytes outside DATA body");
    return -1;
  }
  char *pb;
  Py_ssize_t pn;
  if (PyBytes_AsStringAndSize(payload, &pb, &pn) < 0) return -1;
  if (rc->buf_len + pn > rc->buf_cap) {
    int64_t ncap = rc->buf_cap ? rc->buf_cap * 2 : 256;
    while (ncap < rc->buf_len + pn) ncap *= 2;
    char *nb = realloc(rc->buf, (size_t)ncap);
    if (!nb) { PyErr_NoMemory(); return -1; }
    rc->buf = nb;
    rc->buf_cap = ncap;
  }
  memcpy(rc->buf + rc->buf_len, pb, (size_t)pn);
  rc->buf_len += pn;
  int64_t off = 0;
  int rcod = 0;
  rc->busy++;
  while (!rc->dead && rc->buf_len - off >= TCELL_HDR) {
    unsigned char *b = (unsigned char *)rc->buf + off;
    int ctype = b[0];
    int circ = ((int)b[1] << 8) | b[2];
    int64_t ln = ((int64_t)b[3] << 8) | b[4];
    if (ctype == TC_DATA) {
      off += TCELL_HDR;
      rc->body_left = ln;
      rc->body_circ = circ;
      /* forward the DATA header along the circuit (on_data_hdr twin) */
      int ncid, ncirc;
      if (rtab_get(r, rc->cid, circ, &ncid, &ncirc) && r->conns[ncid]) {
        PyObject *f = build_data_hdr(ncirc, ln);
        if (!f) { rcod = -1; break; }
        if (relay_write(r->conns[ncid], now, f) < 0) { rcod = -1; break; }
      }
      break; /* counted body follows in subsequent chunks */
    }
    if (rc->buf_len - off < TCELL_HDR + ln) break;
    if (relay_on_cell(r, rc, now, ctype, circ,
                      rc->buf + off + TCELL_HDR, (Py_ssize_t)ln) < 0) {
      rcod = -1;
      break;
    }
    off += TCELL_HDR + ln;
  }
  if (!rc->dead && off) {
    memmove(rc->buf, rc->buf + off, (size_t)(rc->buf_len - off));
    rc->buf_len -= off;
  }
  if (--rc->busy == 0 && rc->dead) relay_free_conn(rc);
  return rcod;
}

/* -- teardown cascade (relay _on_conn_close twin) ------------------------ */
static int cmp_peer_seq(const void *a, const void *b) {
  uint64_t x = ((const uint64_t *)a)[0], y = ((const uint64_t *)b)[0];
  return (x > y) - (x < y);
}

static int relay_conn_closed(CRelayConn *rc) {
  CRelayObj *r = rc->relay;
  int cid = rc->cid;
  if (rc->dead) return 0; /* already torn down (re-entrant cascade) */
  r->conns[cid] = NULL;
  rc->ep->sink = NULL;
  /* spliced peers whose KEY side is this cid, in table insertion order
   * (the Python twin iterates its dict) */
  int rcod = 0;
  uint64_t(*peers)[2] =
      malloc(sizeof(uint64_t[2]) * (size_t)(r->tcount ? r->tcount : 1));
  int npeers = 0;
  if (!peers) { PyErr_NoMemory(); rcod = -1; }
  for (int i = 0; rcod == 0 && i < r->tcap; i++) {
    if (!r->tk[i]) continue;
    int kcid = (int)((r->tk[i] - 1) >> 32);
    if (kcid == cid) {
      peers[npeers][0] = r->ts[i];
      peers[npeers][1] = r->tv[i] >> 32;
      npeers++;
    }
  }
  if (npeers > 1)
    qsort(peers, (size_t)npeers, sizeof(uint64_t[2]), cmp_peer_seq);
  /* rebuild the table without entries touching cid, preserving each
   * surviving entry's insertion seq (Python dict-comprehension rebuild
   * keeps the original order) */
  if (rcod == 0) {
    uint64_t *ok = r->tk, *ov = r->tv, *os = r->ts;
    int ocap = r->tcap;
    r->tk = NULL;
    r->tv = NULL;
    r->ts = NULL;
    r->tcap = r->tcount = 0;
    for (int i = 0; i < ocap && rcod == 0; i++) {
      if (!ok[i]) continue;
      int kcid = (int)((ok[i] - 1) >> 32);
      int vcid = (int)(ov[i] >> 32);
      if (kcid == cid || vcid == cid) continue;
      if (rtab_put(r, kcid, (int)(uint32_t)(ok[i] - 1), vcid,
                   (int)(uint32_t)ov[i]) < 0) {
        rcod = -1;
        break;
      }
      /* restore the original seq (rtab_put assigned a fresh one) */
      uint64_t k = ok[i];
      uint64_t h = k * 0x9E3779B97F4A7C15ULL;
      int j = (int)(h & (uint64_t)(r->tcap - 1));
      while (r->tk[j] != k) j = (j + 1) & (r->tcap - 1);
      r->ts[j] = os[i];
    }
    free(ok);
    free(ov);
    free(os);
  }
  int err = 0;
  int64_t now = 0;
  if (rcod == 0) {
    now = cep_now(rc->ep, &err);
    if (err) rcod = -1;
  }
  for (int i = 0; i < npeers && rcod == 0; i++) {
    CRelayConn *pc = r->conns[(int)peers[i][1]];
    if (!pc) continue;
    if (pc->pend.count) {
      pc->close_after_drain = 1;
    } else {
      rcod = cep_begin_close(pc->ep, now);
    }
  }
  free(peers);
  /* free now unless feed/pump frames for this conn are on the stack */
  if (rc->busy)
    rc->dead = 1;
  else
    relay_free_conn(rc);
  return rcod;
}

/* -- the Python-visible CRelay type -------------------------------------- */
static void CRelay_dealloc(CRelayObj *r) {
  PyObject_GC_UnTrack(r);
  for (int i = 0; i < r->nconns; i++) relay_detach_conn(r, i);
  free(r->conns);
  free(r->tk);
  free(r->tv);
  free(r->ts);
  Py_XDECREF(r->core);
  Py_XDECREF(r->on_ctrl);
  Py_TYPE(r)->tp_free((PyObject *)r);
}

static int CRelay_traverse(CRelayObj *r, visitproc visit, void *arg) {
  Py_VISIT(r->core);
  Py_VISIT(r->on_ctrl);
  for (int i = 0; i < r->nconns; i++)
    if (r->conns[i]) Py_VISIT(r->conns[i]->ep);
  return 0;
}

static int CRelay_clear_gc(CRelayObj *r) {
  Py_CLEAR(r->core);
  Py_CLEAR(r->on_ctrl);
  /* a GC collection can run from allocations INSIDE relay_feed (e.g.
   * build_cell), so the busy guard matters here exactly as on the
   * runtime teardown paths (review r4) */
  for (int i = 0; i < r->nconns; i++) relay_detach_conn(r, i);
  return 0;
}

static PyObject *CRelay_add_conn(CRelayObj *r, PyObject *arg) {
  if (Py_TYPE(arg) != &CEp_Type) {
    PyErr_SetString(PyExc_TypeError, "add_conn expects a C endpoint");
    return NULL;
  }
  if (r->nconns == r->conns_cap) {
    int ncap = r->conns_cap ? r->conns_cap * 2 : 16;
    CRelayConn **nc = realloc(r->conns,
                              (size_t)ncap * sizeof(CRelayConn *));
    if (!nc) return PyErr_NoMemory();
    r->conns = nc;
    r->conns_cap = ncap;
  }
  CRelayConn *rc = calloc(1, sizeof(CRelayConn));
  if (!rc) return PyErr_NoMemory();
  rc->relay = r;
  Py_INCREF(arg);
  rc->ep = (CEp *)arg;
  rc->cid = r->nconns;
  rc->pend.esz = sizeof(PendEnt);
  r->conns[r->nconns++] = rc;
  ((CEp *)arg)->sink = rc;
  return PyLong_FromLong(rc->cid);
}

static PyObject *CRelay_splice(CRelayObj *r, PyObject *args) {
  int cid, circ, ncid;
  if (!PyArg_ParseTuple(args, "iii", &cid, &circ, &ncid)) return NULL;
  int ncirc = r->next_circ++;
  if (rtab_put(r, cid, circ, ncid, ncirc) < 0) return NULL;
  if (rtab_put(r, ncid, ncirc, cid, circ) < 0) return NULL;
  return PyLong_FromLong(ncirc);
}

static PyObject *CRelay_write_cell(CRelayObj *r, PyObject *args) {
  int cid, ctype, circ;
  Py_buffer pl = {0};
  if (!PyArg_ParseTuple(args, "iii|y*", &cid, &ctype, &circ, &pl))
    return NULL;
  if (cid < 0 || cid >= r->nconns || !r->conns[cid]) {
    PyBuffer_Release(&pl);
    Py_RETURN_NONE; /* connection already gone */
  }
  PyObject *f = build_cell(ctype, circ, pl.buf, pl.len);
  PyBuffer_Release(&pl);
  if (!f) return NULL;
  int err;
  int64_t now = cep_now(r->conns[cid]->ep, &err);
  if (err) return NULL;
  if (relay_write(r->conns[cid], now, f) < 0) return NULL;
  Py_RETURN_NONE;
}

/* ---- C tor-exit stream (TorExit data path) -----------------------------
 * Attached to the exit's SERVER-side connection: every counted chunk the
 * destination streams back is re-framed as a circuit DATA cell (header +
 * counted body) toward the client, entirely in C; at `want` bytes the
 * server connection closes and an END cell terminates the fetch — the
 * exact order of the Python twin (models/tor.py TorExit._on_cell). The
 * endpoint OWNS the stream (ep->xsink); the stream borrows the ep. */
typedef struct CExitStream {
  PyObject_HEAD
  CEp *ep;          /* borrowed: the owner */
  CRelayObj *relay; /* owned */
  int cid, circ;
  int done;
  int64_t want, got;
} CExitStream;

static PyTypeObject CExitStream_Type;

static int exit_feed(CExitStream *s, int64_t now, int64_t nbytes) {
  CRelayObj *r = s->relay;
  CRelayConn *rc = (s->cid >= 0 && s->cid < r->nconns)
                       ? r->conns[s->cid] : NULL;
  if (rc) {
    PyObject *hdr = build_data_hdr(s->circ, nbytes);
    if (!hdr) return -1;
    if (relay_write(rc, now, hdr) < 0) return -1;
    rc = (s->cid < r->nconns) ? r->conns[s->cid] : NULL; /* may close */
    if (rc && relay_write_counted(rc, now, nbytes) < 0) return -1;
  }
  s->got += nbytes;
  if (s->got >= s->want && !s->done) {
    s->done = 1;
    if (cep_begin_close(s->ep, now) < 0) return -1;
    rc = (s->cid >= 0 && s->cid < r->nconns) ? r->conns[s->cid] : NULL;
    if (rc) {
      PyObject *endc = build_cell(TC_END, s->circ, NULL, 0);
      if (!endc) return -1;
      if (relay_write(rc, now, endc) < 0) return -1;
    }
  }
  return 0;
}

static int CExitStream_traverse(CExitStream *s, visitproc visit,
                                void *arg) {
  Py_VISIT(s->relay);
  return 0;
}

static int CExitStream_clear_gc(CExitStream *s) {
  Py_CLEAR(s->relay);
  return 0;
}

static void CExitStream_dealloc(CExitStream *s) {
  PyObject_GC_UnTrack(s);
  Py_XDECREF(s->relay);
  Py_TYPE(s)->tp_free((PyObject *)s);
}

static PyObject *CExitStream_export_state(CExitStream *s, PyObject *noarg);
static PyObject *CExitStream_restore_state(CExitStream *s, PyObject *state);

static PyMethodDef CExitStream_methods[] = {
    {"_export_state", (PyCFunction)CExitStream_export_state, METH_NOARGS,
     "checkpoint export (the owning endpoint re-links `ep` on restore)"},
    {"_restore_state", (PyCFunction)CExitStream_restore_state, METH_O,
     "checkpoint restore"},
    {NULL, NULL, 0, NULL}};

static PyTypeObject CExitStream_Type = {
    PyVarObject_HEAD_INIT(NULL, 0).tp_name = "_colcore.ExitStream",
    .tp_basicsize = sizeof(CExitStream),
    .tp_dealloc = (destructor)CExitStream_dealloc,
    .tp_flags = Py_TPFLAGS_DEFAULT | Py_TPFLAGS_HAVE_GC,
    .tp_traverse = (traverseproc)CExitStream_traverse,
    .tp_clear = (inquiry)CExitStream_clear_gc,
    .tp_methods = CExitStream_methods,
    .tp_free = PyObject_GC_Del,
    .tp_doc = "C tor-exit reframe stream (models/tor.py TorExit twin)",
};

static PyObject *CRelay_exit_stream(CRelayObj *r, PyObject *args) {
  PyObject *ep_o;
  int cid, circ;
  long long want;
  if (!PyArg_ParseTuple(args, "OiiL", &ep_o, &cid, &circ, &want))
    return NULL;
  if (Py_TYPE(ep_o) != &CEp_Type) {
    PyErr_SetString(PyExc_TypeError, "exit_stream expects a C endpoint");
    return NULL;
  }
  CEp *e = (CEp *)ep_o;
  CExitStream *s = PyObject_GC_New(CExitStream, &CExitStream_Type);
  if (!s) return NULL;
  memset(((char *)s) + sizeof(PyObject), 0,
         sizeof(CExitStream) - sizeof(PyObject));
  s->ep = e;
  Py_INCREF(r);
  s->relay = r;
  s->cid = cid;
  s->circ = circ;
  s->want = want;
  PyObject_GC_Track((PyObject *)s);
  Py_XSETREF(e->xsink, (PyObject *)s); /* the ep owns the stream */
  Py_RETURN_NONE;
}

static PyObject *CRelay_stats(CRelayObj *r, PyObject *noarg) {
  (void)noarg;
  return Py_BuildValue("(LL)", (long long)r->cells_relayed,
                       (long long)r->bytes_relayed);
}

static PyObject *CRelay_export_state(CRelayObj *r, PyObject *noarg);
static PyObject *CRelay_restore_state(CRelayObj *r, PyObject *state);

static PyMethodDef CRelay_methods[] = {
    {"_export_state", (PyCFunction)CRelay_export_state, METH_NOARGS,
     "checkpoint export: conns + circuit table + counters"},
    {"_restore_state", (PyCFunction)CRelay_restore_state, METH_O,
     "checkpoint restore (core binding comes via Core.adopt)"},
    {"add_conn", (PyCFunction)CRelay_add_conn, METH_O,
     "attach a C endpoint as a relay connection -> cid"},
    {"splice", (PyCFunction)CRelay_splice, METH_VARARGS,
     "(cid, circ, ncid) -> ncirc; inserts both circuit-table directions"},
    {"write_cell", (PyCFunction)CRelay_write_cell, METH_VARARGS,
     "(cid, ctype, circ[, payload]) -> queue a control cell"},
    {"exit_stream", (PyCFunction)CRelay_exit_stream, METH_VARARGS,
     "(endpoint, cid, circ, want) -> attach the C exit reframe stream"},
    {"stats", (PyCFunction)CRelay_stats, METH_NOARGS,
     "-> (cells_relayed, bytes_relayed)"},
    {NULL, NULL, 0, NULL}};

static PyTypeObject CRelay_Type = {
    PyVarObject_HEAD_INIT(NULL, 0).tp_name = "_colcore.Relay",
    .tp_basicsize = sizeof(CRelayObj),
    .tp_dealloc = (destructor)CRelay_dealloc,
    .tp_flags = Py_TPFLAGS_DEFAULT | Py_TPFLAGS_HAVE_GC,
    .tp_traverse = (traverseproc)CRelay_traverse,
    .tp_clear = (inquiry)CRelay_clear_gc,
    .tp_methods = CRelay_methods,
    .tp_free = PyObject_GC_Del,
    .tp_doc = "C tor-relay data path (models/tor.py delegates)",
};

static PyObject *Core_relay_new(CoreObject *c, PyObject *args) {
  long long hid;
  PyObject *on_ctrl;
  int exit_mode = 0;
  if (!PyArg_ParseTuple(args, "LO|p", &hid, &on_ctrl, &exit_mode))
    return NULL;
  if (hid < 0 || hid >= c->H) {
    PyErr_SetString(PyExc_ValueError, "host id out of range");
    return NULL;
  }
  CRelayObj *r = PyObject_GC_New(CRelayObj, &CRelay_Type);
  if (!r) return NULL;
  memset(((char *)r) + sizeof(PyObject), 0,
         sizeof(CRelayObj) - sizeof(PyObject));
  Py_INCREF(c);
  r->core = c;
  r->hid = (int)hid;
  Py_INCREF(on_ctrl);
  r->on_ctrl = on_ctrl;
  r->next_circ = 1;
  r->exit_mode = exit_mode;
  PyObject_GC_Track((PyObject *)r);
  return (PyObject *)r;
}

/* ======================================================================
 * C tor-client sink (models/tor.py TorClient data path + control plane).
 *
 * The client's steady state is receiving a stream of DATA cells +
 * counted bodies through its guard connection; this sink owns the frame
 * parsing and body-byte counting in C. Since the circuit-build control
 * plane moved native, it ALSO runs the telescoping state machine: the
 * model hands it the three pre-built advance frames (EXTEND hop2,
 * EXTEND hop3, BEGIN) at creation, and each CREATED/EXTENDED cell
 * advances the stage and writes the next frame through a C pending
 * queue (the bounded-send discipline of the Python twin's _Conn pump).
 * Python sees exactly TWO events per circuit — on_cell fires for the
 * stage-3 EXTENDED (telescoping done; the model records build time) and
 * for END (fetch complete) — instead of every control cell plus every
 * advance write. At tor_100k scale (100,000 clients) this removes the
 * remaining per-circuit Python control-cell handling the same way the
 * relay data path did for relays. Without frames (None) the sink is the
 * pure data path: on_cell fires for every control cell and the model
 * keeps writing through its own conn.
 * ====================================================================== */

typedef struct CTorSink {
  PyObject_HEAD
  CEp *ep;            /* owned; ep->tsink is the borrowed back-pointer */
  PyObject *on_cell;  /* owned: callable(ctype, circ, payload, got) */
  PyObject *frames;   /* owned tuple of 3 advance frames, or NULL */
  int stage;          /* CREATED/EXTENDED cells consumed (twin: stage) */
  Ring pend;          /* PendEnt write queue (_WriteConn pending twin) */
  char *buf;
  int64_t buf_len, buf_cap;
  int64_t body_left;
  int64_t got; /* counted DATA body bytes received (circuit-agnostic,
                  like the Python twin's on_body) */
} CTorSink;

static PyTypeObject CTorSink_Type;

/* the _Conn._pump twin over the C pending ring: offer each frame to the
 * bounded send buffer; a short write parks and resumes on drain */
static int tsink_pump(CTorSink *s, int64_t now) {
  while (s->pend.count) {
    PendEnt *head = ring_at(&s->pend, 0);
    int64_t sent = cs_send(s->ep, now, 0, head->payload, head->a);
    if (sent < 0) return -1;
    head->a += sent;
    int done = head->a >= PyBytes_GET_SIZE(head->payload);
    if (done) {
      Py_XDECREF(head->payload);
      ring_popleft(&s->pend);
    }
    if (sent == 0 && !done) return 0; /* buffer full; drain resumes */
  }
  return 0;
}

/* queue one frame (steals the ref) and pump */
static int tsink_write(CTorSink *s, int64_t now, PyObject *frame) {
  PendEnt *p = ring_push(&s->pend);
  if (!p) { Py_DECREF(frame); return -1; }
  p->payload = frame;
  p->a = 0;
  return tsink_pump(s, now);
}

static int tsink_feed(CTorSink *s, int64_t nbytes, PyObject *payload) {
  if (s->body_left > 0 && (!payload || payload == Py_None)) {
    int64_t take = nbytes < s->body_left ? nbytes : s->body_left;
    s->body_left -= take;
    s->got += take;
    if (nbytes > take) {
      PyErr_SetString(PyExc_ValueError,
                      "framing error: stray counted bytes");
      return -1;
    }
    return 0;
  }
  if (!payload || payload == Py_None) {
    PyErr_SetString(PyExc_ValueError,
                    "framing error: counted bytes outside DATA body");
    return -1;
  }
  char *pb;
  Py_ssize_t pn;
  if (PyBytes_AsStringAndSize(payload, &pb, &pn) < 0) return -1;
  if (s->buf_len + pn > s->buf_cap) {
    int64_t ncap = s->buf_cap ? s->buf_cap * 2 : 256;
    while (ncap < s->buf_len + pn) ncap *= 2;
    char *nb = realloc(s->buf, (size_t)ncap);
    if (!nb) { PyErr_NoMemory(); return -1; }
    s->buf = nb;
    s->buf_cap = ncap;
  }
  memcpy(s->buf + s->buf_len, pb, (size_t)pn);
  s->buf_len += pn;
  int64_t off = 0;
  int rcod = 0;
  Py_INCREF(s); /* the callback may drop the model's last reference */
  while (s->buf_len - off >= TCELL_HDR) {
    unsigned char *b = (unsigned char *)s->buf + off;
    int ctype = b[0];
    int circ = ((int)b[1] << 8) | b[2];
    int64_t ln = ((int64_t)b[3] << 8) | b[4];
    if (ctype == TC_DATA) {
      off += TCELL_HDR;
      s->body_left = ln;
      break; /* counted body follows in subsequent chunks */
    }
    if (s->buf_len - off < TCELL_HDR + ln) break;
    if (s->frames) {
      /* C control plane (TorClient.on_ctrl + advance twin) */
      if (ctype == TC_CREATED || ctype == TC_EXTENDED) {
        s->stage++;
        if (s->stage == 3) {
          /* telescoping done: the ONE mid-build Python event (the model
           * records circuit-build time), then BEGIN goes out below */
          PyObject *pl = PyBytes_FromStringAndSize(
              s->buf + off + TCELL_HDR, (Py_ssize_t)ln);
          if (!pl) { rcod = -1; break; }
          PyObject *r = PyObject_CallFunction(s->on_cell, "iiNL", ctype,
                                              circ, pl, (long long)s->got);
          if (!r) { rcod = -1; break; }
          Py_DECREF(r);
        }
        int idx = s->stage > 3 ? 2 : s->stage - 1;
        PyObject *f = PyTuple_GET_ITEM(s->frames, idx);
        Py_INCREF(f);
        int err;
        int64_t now = cep_now(s->ep, &err);
        if (err) { Py_DECREF(f); rcod = -1; break; }
        if (tsink_write(s, now, f) < 0) { rcod = -1; break; }
        off += TCELL_HDR + ln;
        continue;
      }
      if (ctype != TC_END) { /* CONNECTED etc.: the twin ignores them */
        off += TCELL_HDR + ln;
        continue;
      }
    }
    PyObject *pl = PyBytes_FromStringAndSize(s->buf + off + TCELL_HDR,
                                             (Py_ssize_t)ln);
    if (!pl) { rcod = -1; break; }
    PyObject *r = PyObject_CallFunction(s->on_cell, "iiNL", ctype, circ,
                                        pl, (long long)s->got);
    if (!r) { rcod = -1; break; }
    Py_DECREF(r);
    off += TCELL_HDR + ln;
  }
  if (off && rcod == 0) {
    memmove(s->buf, s->buf + off, (size_t)(s->buf_len - off));
    s->buf_len -= off;
  }
  Py_DECREF(s);
  return rcod;
}

static int CTorSink_traverse(CTorSink *s, visitproc visit, void *arg) {
  Py_VISIT(s->ep);
  Py_VISIT(s->on_cell);
  Py_VISIT(s->frames);
  return 0;
}

static void tsink_clear_pend(CTorSink *s) {
  while (s->pend.count) {
    Py_XDECREF(((PendEnt *)ring_at(&s->pend, 0))->payload);
    ring_popleft(&s->pend);
  }
}

static int CTorSink_clear_gc(CTorSink *s) {
  if (s->ep && s->ep->tsink == s) s->ep->tsink = NULL;
  Py_CLEAR(s->ep);
  Py_CLEAR(s->on_cell);
  Py_CLEAR(s->frames);
  tsink_clear_pend(s);
  return 0;
}

static void CTorSink_dealloc(CTorSink *s) {
  PyObject_GC_UnTrack(s);
  if (s->ep && s->ep->tsink == s) s->ep->tsink = NULL;
  Py_XDECREF(s->ep);
  Py_XDECREF(s->on_cell);
  Py_XDECREF(s->frames);
  tsink_clear_pend(s);
  free(s->pend.buf);
  free(s->buf);
  Py_TYPE(s)->tp_free((PyObject *)s);
}

static PyObject *CTorSink_bytes_received(CTorSink *s, PyObject *noarg) {
  (void)noarg;
  return PyLong_FromLongLong(s->got);
}

static PyObject *CTorSink_write(CTorSink *s, PyObject *arg) {
  /* model-side writes (the initial CREATE cell) ride the same pending
   * queue as the C state machine's advance frames */
  if (!PyBytes_Check(arg)) {
    PyErr_SetString(PyExc_TypeError, "TorSink.write expects bytes");
    return NULL;
  }
  if (!s->ep) {
    PyErr_SetString(PyExc_RuntimeError, "TorSink endpoint is gone");
    return NULL;
  }
  int err;
  int64_t now = cep_now(s->ep, &err);
  if (err) return NULL;
  Py_INCREF(arg);
  if (tsink_write(s, now, arg) < 0) return NULL;
  Py_RETURN_NONE;
}

static PyObject *CTorSink_export_state(CTorSink *s, PyObject *noarg);
static PyObject *CTorSink_restore_state(CTorSink *s, PyObject *state);

static PyMethodDef CTorSink_methods[] = {
    {"bytes_received", (PyCFunction)CTorSink_bytes_received, METH_NOARGS,
     "counted DATA body bytes received so far"},
    {"write", (PyCFunction)CTorSink_write, METH_O,
     "queue one framed cell through the C pending-write queue"},
    {"_export_state", (PyCFunction)CTorSink_export_state, METH_NOARGS,
     "checkpoint export: endpoint + frames + parser + pending queue"},
    {"_restore_state", (PyCFunction)CTorSink_restore_state, METH_O,
     "checkpoint restore (re-links ep->tsink)"},
    {NULL, NULL, 0, NULL}};

static PyTypeObject CTorSink_Type = {
    PyVarObject_HEAD_INIT(NULL, 0).tp_name = "_colcore.TorSink",
    .tp_basicsize = sizeof(CTorSink),
    .tp_dealloc = (destructor)CTorSink_dealloc,
    .tp_flags = Py_TPFLAGS_DEFAULT | Py_TPFLAGS_HAVE_GC,
    .tp_traverse = (traverseproc)CTorSink_traverse,
    .tp_clear = (inquiry)CTorSink_clear_gc,
    .tp_methods = CTorSink_methods,
    .tp_free = PyObject_GC_Del,
    .tp_doc = "C tor-client frame sink + circuit-build control plane "
              "(models/tor.py TorClient twin)",
};

static PyObject *Core_tor_client_sink(CoreObject *c, PyObject *args) {
  (void)c;
  PyObject *ep_o, *on_cell, *frames = Py_None;
  if (!PyArg_ParseTuple(args, "OO|O", &ep_o, &on_cell, &frames))
    return NULL;
  if (Py_TYPE(ep_o) != &CEp_Type) {
    PyErr_SetString(PyExc_TypeError, "tor_client_sink expects a C endpoint");
    return NULL;
  }
  if (frames != Py_None &&
      (!PyTuple_Check(frames) || PyTuple_GET_SIZE(frames) != 3 ||
       !PyBytes_Check(PyTuple_GET_ITEM(frames, 0)) ||
       !PyBytes_Check(PyTuple_GET_ITEM(frames, 1)) ||
       !PyBytes_Check(PyTuple_GET_ITEM(frames, 2)))) {
    PyErr_SetString(PyExc_TypeError,
                    "tor_client_sink frames must be a 3-tuple of bytes "
                    "(EXTEND hop2, EXTEND hop3, BEGIN)");
    return NULL;
  }
  CTorSink *s = PyObject_GC_New(CTorSink, &CTorSink_Type);
  if (!s) return NULL;
  memset(((char *)s) + sizeof(PyObject), 0,
         sizeof(CTorSink) - sizeof(PyObject));
  Py_INCREF(ep_o);
  s->ep = (CEp *)ep_o;
  Py_INCREF(on_cell);
  s->on_cell = on_cell;
  if (frames != Py_None) {
    Py_INCREF(frames);
    s->frames = frames;
  }
  s->pend.esz = sizeof(PendEnt);
  s->ep->tsink = s;
  PyObject_GC_Track((PyObject *)s);
  return (PyObject *)s;
}

/* ======================================================================
 * Checkpoint export/restore (shadow_tpu/checkpoint.py).
 *
 * Every C object that can be live at a round boundary — stream
 * endpoints, tor relays/sinks/exit streams, gossip states, packed store
 * batches — exports its COMPLETE state as plain Python structures
 * (ints, bytes, lists, the callbacks themselves), and rebuilds from
 * them: checkpoint._SimPickler reduces each object to
 * (shell(kind), state, _restore_state) so shared references and
 * reference cycles ride the pickle memo exactly like Python objects.
 * Core pointers are NOT exported: Controller._reattach_runtime rebuilds
 * the Core and binds the restored objects via Core.adopt(). The
 * module-level ABI constant ties a checkpoint to this state format —
 * the checkpoint header refuses a mismatch by name.
 * ====================================================================== */

static PyObject *ornone(PyObject *o) { return o ? o : Py_None; }

/* -- ring export/restore helpers ---------------------------------------- */
static PyObject *export_sq(Ring *r) {
  PyObject *l = PyList_New(r->count);
  if (!l) return NULL;
  for (int i = 0; i < r->count; i++) {
    SQEnt *q = ring_at(r, i);
    PyObject *t = Py_BuildValue("(LO)", (long long)q->nbytes,
                                ornone(q->payload));
    if (!t) { Py_DECREF(l); return NULL; }
    PyList_SET_ITEM(l, i, t);
  }
  return l;
}

static PyObject *export_rtx(Ring *r) {
  PyObject *l = PyList_New(r->count);
  if (!l) return NULL;
  for (int i = 0; i < r->count; i++) {
    RtxEnt *q = ring_at(r, i);
    PyObject *t = Py_BuildValue("(LLO)", (long long)q->seq,
                                (long long)q->n, ornone(q->payload));
    if (!t) { Py_DECREF(l); return NULL; }
    PyList_SET_ITEM(l, i, t);
  }
  return l;
}

static PyObject *export_pend(Ring *r) {
  PyObject *l = PyList_New(r->count);
  if (!l) return NULL;
  for (int i = 0; i < r->count; i++) {
    PendEnt *q = ring_at(r, i);
    PyObject *t = Py_BuildValue("(OL)", ornone(q->payload),
                                (long long)q->a);
    if (!t) { Py_DECREF(l); return NULL; }
    PyList_SET_ITEM(l, i, t);
  }
  return l;
}

static int restore_sq(Ring *r, PyObject *l) {
  if (!PyList_Check(l)) {
    PyErr_SetString(PyExc_TypeError, "restore: expected a list");
    return -1;
  }
  for (Py_ssize_t i = 0; i < PyList_GET_SIZE(l); i++) {
    long long n;
    PyObject *pl;
    if (!PyArg_ParseTuple(PyList_GET_ITEM(l, i), "LO", &n, &pl)) return -1;
    SQEnt *q = ring_push(r);
    if (!q) return -1;
    q->nbytes = n;
    q->payload = pl == Py_None ? NULL : (Py_INCREF(pl), pl);
  }
  return 0;
}

static int restore_rtx(Ring *r, PyObject *l) {
  if (!PyList_Check(l)) {
    PyErr_SetString(PyExc_TypeError, "restore: expected a list");
    return -1;
  }
  for (Py_ssize_t i = 0; i < PyList_GET_SIZE(l); i++) {
    long long seq, n;
    PyObject *pl;
    if (!PyArg_ParseTuple(PyList_GET_ITEM(l, i), "LLO", &seq, &n, &pl))
      return -1;
    RtxEnt *q = ring_push(r);
    if (!q) return -1;
    q->seq = seq;
    q->n = n;
    q->payload = pl == Py_None ? NULL : (Py_INCREF(pl), pl);
  }
  return 0;
}

static int restore_pend(Ring *r, PyObject *l) {
  if (!PyList_Check(l)) {
    PyErr_SetString(PyExc_TypeError, "restore: expected a list");
    return -1;
  }
  for (Py_ssize_t i = 0; i < PyList_GET_SIZE(l); i++) {
    long long a;
    PyObject *pl;
    if (!PyArg_ParseTuple(PyList_GET_ITEM(l, i), "OL", &pl, &a)) return -1;
    PendEnt *q = ring_push(r);
    if (!q) return -1;
    q->a = a;
    q->payload = pl == Py_None ? NULL : (Py_INCREF(pl), pl);
  }
  return 0;
}

/* -- shells (empty objects the unpickler fills via _restore_state) ------- */
static CEp *cep_shell(void) {
  CEp *e = PyObject_GC_New(CEp, &CEp_Type);
  if (!e) return NULL;
  memset(((char *)e) + sizeof(PyObject), 0, sizeof(CEp) - sizeof(PyObject));
  e->sendbuf.esz = sizeof(SQEnt);
  e->rtx.esz = sizeof(RtxEnt);
  e->ooo.esz = sizeof(RtxEnt);
  e->sacked.esz = sizeof(int64_t);
  e->rtx_done.esz = sizeof(int64_t);
  e->tgen_t_first = -1;
  PyObject_GC_Track((PyObject *)e);
  return e;
}

static CRelayObj *relay_shell(void) {
  CRelayObj *r = PyObject_GC_New(CRelayObj, &CRelay_Type);
  if (!r) return NULL;
  memset(((char *)r) + sizeof(PyObject), 0,
         sizeof(CRelayObj) - sizeof(PyObject));
  r->next_circ = 1;
  PyObject_GC_Track((PyObject *)r);
  return r;
}

static CTorSink *tsink_shell(void) {
  CTorSink *s = PyObject_GC_New(CTorSink, &CTorSink_Type);
  if (!s) return NULL;
  memset(((char *)s) + sizeof(PyObject), 0,
         sizeof(CTorSink) - sizeof(PyObject));
  s->pend.esz = sizeof(PendEnt);
  PyObject_GC_Track((PyObject *)s);
  return s;
}

static CExitStream *xstream_shell(void) {
  CExitStream *s = PyObject_GC_New(CExitStream, &CExitStream_Type);
  if (!s) return NULL;
  memset(((char *)s) + sizeof(PyObject), 0,
         sizeof(CExitStream) - sizeof(PyObject));
  PyObject_GC_Track((PyObject *)s);
  return s;
}

static GossipState *gossip_shell(void) {
  GossipState *g = PyObject_GC_New(GossipState, &GossipState_Type);
  if (!g) return NULL;
  g->core = NULL;
  g->hid = 0;
  g->port = 0;
  g->port_obj = NULL;
  g->peers = NULL;
  g->npeers = 0;
  memset(&g->seen, 0, sizeof g->seen);
  g->received_tx = 0;
  g->next_dgram = 0;
  PyObject_GC_Track((PyObject *)g);
  return g;
}

/* -- CEp export/restore (55 positional fields; ABI-guarded) -------------- */
static PyObject *CEp_export_state(CEp *e, PyObject *noarg) {
  (void)noarg;
  PyObject *sb = export_sq(&e->sendbuf);
  PyObject *rt = sb ? export_rtx(&e->rtx) : NULL;
  PyObject *oo = rt ? export_rtx(&e->ooo) : NULL;
  PyObject *sk = oo ? i64set_sorted_tuple(&e->sacked) : NULL;
  PyObject *rd = sk ? i64set_sorted_tuple(&e->rtx_done) : NULL;
  if (!rd) {
    Py_XDECREF(sb);
    Py_XDECREF(rt);
    Py_XDECREF(oo);
    Py_XDECREF(sk);
    return NULL;
  }
  return Py_BuildValue(
      "(iiiiOiiiOLOLLLLLLLLLLiiONNLLLLLiNOOOOOOiLLOLOLOiLLiLLNN)",
      e->hid, e->local_port, e->remote_host, e->remote_port,
      e->initiator ? Py_True : Py_False, e->state, e->syn_tries,
      e->fin_tries, e->peer_fin ? Py_True : Py_False,
      (long long)e->rto_ns, ornone(e->ctl_timer), (long long)e->chunk,
      (long long)e->cwnd, (long long)e->ssthresh,
      (long long)e->send_buffer, (long long)e->snd_nxt,
      (long long)e->snd_una, (long long)e->adv_wnd,
      (long long)e->buffered, (long long)e->bytes_acked,
      (long long)e->rto_backoff, e->retries, e->loss_events,
      ornone(e->rto_timer), sb, rt, (long long)e->recv_buffer,
      (long long)e->rcv_nxt, (long long)e->ooo_bytes,
      (long long)e->bytes_received, (long long)e->last_wnd, e->dup_acks,
      oo, ornone(e->app_unread), ornone(e->on_connected),
      ornone(e->on_data), ornone(e->on_drain), ornone(e->on_close),
      ornone(e->on_error), e->tgen_mode, (long long)e->tgen_pending,
      (long long)e->tgen_want, ornone(e->tgen_cb),
      (long long)e->tgen_t_first, ornone(e->xsink),
      (long long)e->idle_timeout_ns, ornone(e->idle_timer),
      e->cc_kind, (long long)e->w_max, (long long)e->epoch_start,
      e->in_recovery ? 1 : 0, (long long)e->recover,
      (long long)e->sack_high, sk, rd);
}

static PyObject *CEp_restore_state(CEp *e, PyObject *state) {
  int hid, lport, rhost, rport, initiator, st, syn_tries, fin_tries,
      peer_fin, retries, loss_events, dup_acks, tgen_mode, cc_kind,
      in_recovery;
  long long rto_ns, chunk, cwnd, ssthresh, sbuf, snd_nxt, snd_una,
      adv_wnd, buffered, bytes_acked, rto_backoff, rbuf, rcv_nxt,
      ooo_bytes, bytes_received, last_wnd, tgen_pending, tgen_want,
      tgen_t_first, idle_ns, w_max, epoch_start, recover, sack_high;
  PyObject *ctl_t, *rto_t, *sb, *rt, *oo, *app_unread, *on_connected,
      *on_data, *on_drain, *on_close, *on_error, *tgen_cb, *xs, *idle_t,
      *sk, *rd;
  if (!PyArg_ParseTuple(
          state, "iiiiiiiiiLOLLLLLLLLLLiiOOOLLLLLiOOOOOOOiLLOLOLOiLLiLLOO",
          &hid, &lport, &rhost, &rport, &initiator, &st, &syn_tries,
          &fin_tries, &peer_fin, &rto_ns, &ctl_t, &chunk, &cwnd,
          &ssthresh, &sbuf, &snd_nxt, &snd_una, &adv_wnd, &buffered,
          &bytes_acked, &rto_backoff, &retries, &loss_events, &rto_t,
          &sb, &rt, &rbuf, &rcv_nxt, &ooo_bytes, &bytes_received,
          &last_wnd, &dup_acks, &oo, &app_unread, &on_connected,
          &on_data, &on_drain, &on_close, &on_error, &tgen_mode,
          &tgen_pending, &tgen_want, &tgen_cb, &tgen_t_first, &xs,
          &idle_ns, &idle_t, &cc_kind, &w_max, &epoch_start,
          &in_recovery, &recover, &sack_high, &sk, &rd))
    return NULL;
  e->hid = hid;
  e->local_port = lport;
  e->remote_host = rhost;
  e->remote_port = rport;
  e->initiator = initiator;
  e->state = st;
  e->syn_tries = syn_tries;
  e->fin_tries = fin_tries;
  e->peer_fin = peer_fin;
  e->rto_ns = rto_ns;
  e->chunk = chunk;
  e->cwnd = cwnd;
  e->ssthresh = ssthresh;
  e->send_buffer = sbuf;
  e->snd_nxt = snd_nxt;
  e->snd_una = snd_una;
  e->adv_wnd = adv_wnd;
  e->buffered = buffered;
  e->bytes_acked = bytes_acked;
  e->rto_backoff = rto_backoff;
  e->retries = retries;
  e->loss_events = loss_events;
  e->recv_buffer = rbuf;
  e->rcv_nxt = rcv_nxt;
  e->ooo_bytes = ooo_bytes;
  e->bytes_received = bytes_received;
  e->last_wnd = last_wnd;
  e->dup_acks = dup_acks;
  e->tgen_mode = tgen_mode;
  e->tgen_pending = tgen_pending;
  e->tgen_want = tgen_want;
  e->tgen_t_first = tgen_t_first;
  e->idle_timeout_ns = idle_ns;
  e->cc_kind = cc_kind;
  e->w_max = w_max;
  e->epoch_start = epoch_start;
  e->in_recovery = in_recovery;
  e->recover = recover;
  e->sack_high = sack_high;
  if (i64set_restore(&e->sacked, sk) < 0) return NULL;
  if (i64set_restore(&e->rtx_done, rd) < 0) return NULL;
#define EP_SLOT(slot, v)                                \
  do {                                                  \
    PyObject *nv = (v) == Py_None ? NULL : (v);         \
    Py_XINCREF(nv);                                     \
    Py_XSETREF(slot, nv);                               \
  } while (0)
  EP_SLOT(e->ctl_timer, ctl_t);
  EP_SLOT(e->rto_timer, rto_t);
  EP_SLOT(e->idle_timer, idle_t);
  EP_SLOT(e->app_unread, app_unread);
  EP_SLOT(e->on_connected, on_connected);
  EP_SLOT(e->on_data, on_data);
  EP_SLOT(e->on_drain, on_drain);
  EP_SLOT(e->on_close, on_close);
  EP_SLOT(e->on_error, on_error);
  EP_SLOT(e->tgen_cb, tgen_cb);
#undef EP_SLOT
  if (restore_sq(&e->sendbuf, sb) < 0) return NULL;
  if (restore_rtx(&e->rtx, rt) < 0) return NULL;
  if (restore_rtx(&e->ooo, oo) < 0) return NULL;
  if (xs != Py_None) {
    if (Py_TYPE(xs) != &CExitStream_Type) {
      PyErr_SetString(PyExc_TypeError,
                      "endpoint restore: xsink is not an ExitStream");
      return NULL;
    }
    Py_INCREF(xs);
    Py_XSETREF(e->xsink, xs);
    ((CExitStream *)xs)->ep = e; /* borrowed back-pointer (owner = us) */
  }
  Py_RETURN_NONE;
}

/* -- CRelay export/restore ------------------------------------------------ */
typedef struct { uint64_t ts, k, v; } TExp;

static int cmp_texp(const void *a, const void *b) {
  uint64_t x = ((const TExp *)a)->ts, y = ((const TExp *)b)->ts;
  return (x > y) - (x < y);
}

static PyObject *CRelay_export_state(CRelayObj *r, PyObject *noarg) {
  (void)noarg;
  PyObject *conns = PyList_New(r->nconns);
  if (!conns) return NULL;
  for (int i = 0; i < r->nconns; i++) {
    CRelayConn *rc = r->conns[i];
    if (!rc) {
      Py_INCREF(Py_None);
      PyList_SET_ITEM(conns, i, Py_None);
      continue;
    }
    PyObject *pend = export_pend(&rc->pend);
    if (!pend) { Py_DECREF(conns); return NULL; }
    PyObject *buf = PyBytes_FromStringAndSize(
        rc->buf ? rc->buf : "", (Py_ssize_t)rc->buf_len);
    if (!buf) { Py_DECREF(pend); Py_DECREF(conns); return NULL; }
    PyObject *t = Py_BuildValue("(OiNLiN)", (PyObject *)rc->ep,
                                rc->close_after_drain, buf,
                                (long long)rc->body_left, rc->body_circ,
                                pend);
    if (!t) { Py_DECREF(conns); return NULL; }
    PyList_SET_ITEM(conns, i, t);
  }
  /* circuit table in dict insertion order (the ts seq) */
  TExp *te = malloc(sizeof(TExp) * (size_t)(r->tcount ? r->tcount : 1));
  if (!te) { Py_DECREF(conns); return PyErr_NoMemory(); }
  int m = 0;
  for (int i = 0; i < r->tcap; i++) {
    if (!r->tk[i]) continue;
    te[m].ts = r->ts[i];
    te[m].k = r->tk[i];
    te[m].v = r->tv[i];
    m++;
  }
  if (m > 1) qsort(te, (size_t)m, sizeof(TExp), cmp_texp);
  PyObject *tab = PyList_New(m);
  if (!tab) { free(te); Py_DECREF(conns); return NULL; }
  for (int i = 0; i < m; i++) {
    uint64_t k = te[i].k - 1;
    PyObject *t = Py_BuildValue("(iiii)", (int)(k >> 32),
                                (int)(uint32_t)k, (int)(te[i].v >> 32),
                                (int)(uint32_t)te[i].v);
    if (!t) { free(te); Py_DECREF(tab); Py_DECREF(conns); return NULL; }
    PyList_SET_ITEM(tab, i, t);
  }
  free(te);
  return Py_BuildValue("(iOiiLLNN)", r->hid, ornone(r->on_ctrl),
                       r->exit_mode, r->next_circ,
                       (long long)r->cells_relayed,
                       (long long)r->bytes_relayed, conns, tab);
}

static PyObject *CRelay_restore_state(CRelayObj *r, PyObject *state) {
  int hid, exit_mode, next_circ;
  long long cells, nbytes;
  PyObject *on_ctrl, *conns, *tab;
  if (!PyArg_ParseTuple(state, "iOiiLLOO", &hid, &on_ctrl, &exit_mode,
                        &next_circ, &cells, &nbytes, &conns, &tab))
    return NULL;
  if (!PyList_Check(conns) || !PyList_Check(tab)) {
    PyErr_SetString(PyExc_TypeError, "relay restore: expected lists");
    return NULL;
  }
  r->hid = hid;
  if (on_ctrl != Py_None) {
    Py_INCREF(on_ctrl);
    Py_XSETREF(r->on_ctrl, on_ctrl);
  }
  r->exit_mode = exit_mode;
  r->next_circ = next_circ;
  r->cells_relayed = cells;
  r->bytes_relayed = nbytes;
  int n = (int)PyList_GET_SIZE(conns);
  r->conns = calloc((size_t)(n ? n : 1), sizeof(CRelayConn *));
  if (!r->conns) return PyErr_NoMemory();
  r->conns_cap = n ? n : 1;
  r->nconns = n;
  for (int i = 0; i < n; i++) {
    PyObject *it = PyList_GET_ITEM(conns, i);
    if (it == Py_None) continue;
    PyObject *ep, *buf, *pend;
    int cad, bcirc;
    long long bleft;
    if (!PyArg_ParseTuple(it, "OiOLiO", &ep, &cad, &buf, &bleft, &bcirc,
                          &pend))
      return NULL;
    if (Py_TYPE(ep) != &CEp_Type || !PyBytes_Check(buf)) {
      PyErr_SetString(PyExc_TypeError,
                      "relay restore: bad conn entry types");
      return NULL;
    }
    CRelayConn *rc = calloc(1, sizeof(CRelayConn));
    if (!rc) return PyErr_NoMemory();
    rc->relay = r;
    Py_INCREF(ep);
    rc->ep = (CEp *)ep;
    rc->cid = i;
    rc->close_after_drain = cad;
    rc->body_left = bleft;
    rc->body_circ = bcirc;
    rc->pend.esz = sizeof(PendEnt);
    r->conns[i] = rc; /* registered first: dealloc cleans up on error */
    Py_ssize_t bl = PyBytes_GET_SIZE(buf);
    if (bl) {
      rc->buf = malloc((size_t)bl);
      if (!rc->buf) return PyErr_NoMemory();
      memcpy(rc->buf, PyBytes_AS_STRING(buf), (size_t)bl);
      rc->buf_len = bl;
      rc->buf_cap = bl;
    }
    if (restore_pend(&rc->pend, pend) < 0) return NULL;
    ((CEp *)ep)->sink = rc;
  }
  for (Py_ssize_t i = 0; i < PyList_GET_SIZE(tab); i++) {
    int cid, circ, ncid, ncirc;
    if (!PyArg_ParseTuple(PyList_GET_ITEM(tab, i), "iiii", &cid, &circ,
                          &ncid, &ncirc))
      return NULL;
    if (rtab_put(r, cid, circ, ncid, ncirc) < 0) return NULL;
  }
  Py_RETURN_NONE;
}

/* -- CTorSink / CExitStream export/restore -------------------------------- */
static PyObject *CTorSink_export_state(CTorSink *s, PyObject *noarg) {
  (void)noarg;
  PyObject *pend = export_pend(&s->pend);
  if (!pend) return NULL;
  PyObject *buf = PyBytes_FromStringAndSize(s->buf ? s->buf : "",
                                            (Py_ssize_t)s->buf_len);
  if (!buf) { Py_DECREF(pend); return NULL; }
  return Py_BuildValue("(OOOiNNLL)", ornone((PyObject *)s->ep),
                       ornone(s->on_cell), ornone(s->frames), s->stage,
                       pend, buf, (long long)s->body_left,
                       (long long)s->got);
}

static PyObject *CTorSink_restore_state(CTorSink *s, PyObject *state) {
  PyObject *ep, *on_cell, *frames, *pend, *buf;
  int stage;
  long long bleft, got;
  if (!PyArg_ParseTuple(state, "OOOiOOLL", &ep, &on_cell, &frames,
                        &stage, &pend, &buf, &bleft, &got))
    return NULL;
  if (ep == Py_None || Py_TYPE(ep) != &CEp_Type || !PyBytes_Check(buf)) {
    PyErr_SetString(PyExc_TypeError, "tor-sink restore: bad state types");
    return NULL;
  }
  Py_INCREF(ep);
  Py_XSETREF(s->ep, (CEp *)ep);
  s->ep->tsink = s; /* the borrowed back-pointer the data path follows */
  if (on_cell != Py_None) {
    Py_INCREF(on_cell);
    Py_XSETREF(s->on_cell, on_cell);
  }
  if (frames != Py_None) {
    Py_INCREF(frames);
    Py_XSETREF(s->frames, frames);
  }
  s->stage = stage;
  if (restore_pend(&s->pend, pend) < 0) return NULL;
  Py_ssize_t bl = PyBytes_GET_SIZE(buf);
  if (bl) {
    s->buf = malloc((size_t)bl);
    if (!s->buf) return PyErr_NoMemory();
    memcpy(s->buf, PyBytes_AS_STRING(buf), (size_t)bl);
    s->buf_len = bl;
    s->buf_cap = bl;
  }
  s->body_left = bleft;
  s->got = got;
  Py_RETURN_NONE;
}

static PyObject *CExitStream_export_state(CExitStream *s, PyObject *noarg) {
  (void)noarg;
  return Py_BuildValue("(OiiiLL)", ornone((PyObject *)s->relay), s->cid,
                       s->circ, s->done, (long long)s->want,
                       (long long)s->got);
}

static PyObject *CExitStream_restore_state(CExitStream *s,
                                           PyObject *state) {
  PyObject *relay;
  int cid, circ, done;
  long long want, got;
  if (!PyArg_ParseTuple(state, "OiiiLL", &relay, &cid, &circ, &done,
                        &want, &got))
    return NULL;
  if (relay == Py_None || Py_TYPE(relay) != &CRelay_Type) {
    PyErr_SetString(PyExc_TypeError,
                    "exit-stream restore: relay is not a Relay");
    return NULL;
  }
  Py_INCREF(relay);
  Py_XSETREF(s->relay, (CRelayObj *)relay);
  s->cid = cid;
  s->circ = circ;
  s->done = done;
  s->want = want;
  s->got = got;
  /* s->ep is set by the OWNING endpoint's _restore_state */
  Py_RETURN_NONE;
}

/* -- GossipState export/restore ------------------------------------------- */
typedef struct { uint32_t off; uint16_t len; } SeenExp;

static int cmp_seen_off(const void *a, const void *b) {
  uint32_t x = ((const SeenExp *)a)->off, y = ((const SeenExp *)b)->off;
  return (x > y) - (x < y);
}

static PyObject *Gossip_export_state(GossipState *g, PyObject *noarg) {
  (void)noarg;
  PyObject *peers = PyList_New(g->npeers);
  if (!peers) return NULL;
  for (int i = 0; i < g->npeers; i++) {
    PyObject *v = PyLong_FromLong(g->peers[i]);
    if (!v) { Py_DECREF(peers); return NULL; }
    PyList_SET_ITEM(peers, i, v);
  }
  /* seen keys in ARENA (insertion) order so re-adding reproduces the
   * identical arena layout */
  SeenSet *ss = &g->seen;
  size_t cnt = ss->count;
  SeenExp *se = malloc(sizeof(SeenExp) * (cnt ? cnt : 1));
  if (!se) { Py_DECREF(peers); return PyErr_NoMemory(); }
  size_t m = 0;
  for (size_t i = 0; ss->hash && i < ss->cap; i++) {
    if (!ss->hash[i]) continue;
    se[m].off = ss->off[i];
    se[m].len = ss->len[i];
    m++;
  }
  if (m > 1) qsort(se, m, sizeof(SeenExp), cmp_seen_off);
  PyObject *seen = PyList_New((Py_ssize_t)m);
  if (!seen) { free(se); Py_DECREF(peers); return NULL; }
  for (size_t i = 0; i < m; i++) {
    PyObject *b = PyBytes_FromStringAndSize(ss->arena + se[i].off,
                                            (Py_ssize_t)se[i].len);
    if (!b) { free(se); Py_DECREF(seen); Py_DECREF(peers); return NULL; }
    PyList_SET_ITEM(seen, (Py_ssize_t)i, b);
  }
  free(se);
  return Py_BuildValue("(iiNNLL)", g->hid, g->port, peers, seen,
                       (long long)g->received_tx,
                       (long long)g->next_dgram);
}

static PyObject *Gossip_restore_state(GossipState *g, PyObject *state) {
  int hid, port;
  PyObject *peers, *seen;
  long long rtx, nd;
  if (!PyArg_ParseTuple(state, "iiOOLL", &hid, &port, &peers, &seen,
                        &rtx, &nd))
    return NULL;
  if (!PyList_Check(peers) || !PyList_Check(seen)) {
    PyErr_SetString(PyExc_TypeError, "gossip restore: expected lists");
    return NULL;
  }
  g->hid = hid;
  g->port = port;
  PyObject *po = PyLong_FromLong(port);
  if (!po) return NULL;
  Py_XSETREF(g->port_obj, po);
  Py_ssize_t np = PyList_GET_SIZE(peers);
  free(g->peers);
  g->peers = malloc(sizeof(int32_t) * (size_t)(np ? np : 1));
  if (!g->peers) { g->npeers = 0; return PyErr_NoMemory(); }
  g->npeers = (int)np;
  for (Py_ssize_t i = 0; i < np; i++) {
    g->peers[i] =
        (int32_t)PyLong_AsLongLong(PyList_GET_ITEM(peers, i));
  }
  if (PyErr_Occurred()) return NULL;
  seen_free(&g->seen);
  if (seen_init(&g->seen) < 0) return PyErr_NoMemory();
  for (Py_ssize_t i = 0; i < PyList_GET_SIZE(seen); i++) {
    PyObject *b = PyList_GET_ITEM(seen, i);
    char *kb;
    Py_ssize_t kn;
    if (PyBytes_AsStringAndSize(b, &kb, &kn) < 0) return NULL;
    if (seen_add(&g->seen, kb, kn) < 0) return PyErr_NoMemory();
  }
  g->received_tx = rtx;
  g->next_dgram = nd;
  Py_RETURN_NONE;
}

/* -- CBatch export/restore ------------------------------------------------ */
static PyObject *CBatch_export_rows(CBatch *b, PyObject *noarg) {
  (void)noarg;
  PyObject *rows = PyList_New(b->n);
  if (!rows) return NULL;
  for (int i = 0; i < b->n; i++) {
    PyObject *t = srec_tuple(&b->recs[i], b->pay[i]);
    if (!t) { Py_DECREF(rows); return NULL; }
    PyList_SET_ITEM(rows, i, t);
  }
  return Py_BuildValue("(iN)", b->pos, rows);
}

static PyObject *CBatch_restore_state(CBatch *b, PyObject *state) {
  int pos;
  PyObject *rows;
  if (!PyArg_ParseTuple(state, "iO", &pos, &rows)) return NULL;
  if (!PyList_Check(rows)) {
    PyErr_SetString(PyExc_TypeError, "batch restore: expected a list");
    return NULL;
  }
  int n = (int)PyList_GET_SIZE(rows);
  for (int i = 0; i < b->n; i++) Py_CLEAR(b->pay[i]);
  free(b->recs);
  free(b->pay);
  b->n = 0;
  b->recs = malloc(sizeof(SRec) * (size_t)(n ? n : 1));
  b->pay = calloc((size_t)(n ? n : 1), sizeof(PyObject *));
  if (!b->recs || !b->pay) return PyErr_NoMemory();
  b->n = n;
  b->pos = pos;
  for (int i = 0; i < n; i++) {
    PyObject *r = PyList_GET_ITEM(rows, i);
    if (!PyTuple_Check(r) || PyTuple_GET_SIZE(r) != 13) {
      PyErr_SetString(PyExc_TypeError,
                      "batch restore: rows must be 13-tuples");
      return NULL;
    }
    SRec *s = &b->recs[i];
    s->t = tup_i64(r, 0);
    s->key = tup_i64(r, 1);
    s->tgt = (int32_t)tup_i64(r, 2);
    s->kind = (int16_t)tup_i64(r, 3);
    s->peer = (int32_t)tup_i64(r, 4);
    s->aport = (int32_t)tup_i64(r, 5);
    s->bport = (int32_t)tup_i64(r, 6);
    s->nbytes = tup_i64(r, 7);
    s->seq = tup_i64(r, 8);
    s->frag = (int32_t)tup_i64(r, 9);
    s->nfrags = (int32_t)tup_i64(r, 10);
    s->size = (int32_t)tup_i64(r, 11);
    PyObject *pl = PyTuple_GET_ITEM(r, 12);
    if (pl != Py_None) {
      Py_INCREF(pl);
      b->pay[i] = pl;
    }
  }
  if (PyErr_Occurred()) return NULL;
  Py_RETURN_NONE;
}

/* -- shell factory + adoption --------------------------------------------- */
static PyObject *mod_shell(PyObject *self, PyObject *arg) {
  (void)self;
  const char *k = PyUnicode_AsUTF8(arg);
  if (!k) return NULL;
  if (!strcmp(k, "Endpoint")) return (PyObject *)cep_shell();
  if (!strcmp(k, "Relay")) return (PyObject *)relay_shell();
  if (!strcmp(k, "TorSink")) return (PyObject *)tsink_shell();
  if (!strcmp(k, "ExitStream")) return (PyObject *)xstream_shell();
  if (!strcmp(k, "GossipState")) return (PyObject *)gossip_shell();
  if (!strcmp(k, "CBatch")) return (PyObject *)cbatch_new(0);
  return PyErr_Format(PyExc_ValueError, "unknown colcore shell kind %s",
                      k);
}

/* ======================================================================
 * Transport column snapshot/adopt ABI (PR 11, colcore ABI 4): the C
 * half of the device-resident columnar transport's three-surface
 * contract.  transport_columns exports every C stream endpoint's hot
 * integer state as struct-of-arrays int64 numpy columns — the EXACT
 * field set and canonical order of network/devtransport.py's
 * export_columns (hosts in id order, connections in sorted-key order),
 * so the cross-plane identity gates can diff a C run's columns against
 * a Python run's byte for byte.  adopt_transport_columns is the
 * window-edge writeback: only the pure window/CC arithmetic columns
 * (devtransport.ADOPT_COLUMNS) are writable — never sequence/buffer
 * state, whose ring invariants are owned by the scalar machinery.
 * ====================================================================== */

#define N_TCOLS 28
static const char *TCOL_NAMES[N_TCOLS] = {
    "hid",        "local_port", "remote_host",    "remote_port",
    "state",      "cwnd",       "ssthresh",       "snd_nxt",
    "snd_una",    "adv_wnd",    "buffered",       "bytes_acked",
    "rto_backoff", "retries",   "dup_acks",       "loss_events",
    "cc_id",      "in_recovery", "recover",       "sack_high",
    "w_max",      "epoch_start", "sacked_n",      "rtx_done_n",
    "rcv_nxt",    "ooo_bytes",  "bytes_received", "last_wnd"};

static PyObject *Core_transport_columns(CoreObject *c, PyObject *noarg) {
  (void)noarg;
  /* collect C endpoints in canonical order */
  int cap = 256, n = 0;
  CEp **eps = malloc(sizeof(CEp *) * (size_t)cap);
  if (!eps) return PyErr_NoMemory();
  for (int64_t hid = 0; hid < c->H; hid++) {
    CHost *h = &c->hs[hid];
    if (!h->conns) continue;
    PyObject *keys = PyDict_Keys(h->conns);
    if (!keys || PyList_Sort(keys) < 0) {
      Py_XDECREF(keys);
      free(eps);
      return NULL;
    }
    Py_ssize_t nk = PyList_GET_SIZE(keys);
    for (Py_ssize_t i = 0; i < nk; i++) {
      PyObject *v = PyDict_GetItem(h->conns, PyList_GET_ITEM(keys, i));
      if (!v || Py_TYPE(v) != &CEp_Type) continue; /* pcap hosts stay py */
      if (n == cap) {
        cap *= 2;
        CEp **ne = realloc(eps, sizeof(CEp *) * (size_t)cap);
        if (!ne) {
          Py_DECREF(keys);
          free(eps);
          return PyErr_NoMemory();
        }
        eps = ne;
      }
      eps[n++] = (CEp *)v;
    }
    Py_DECREF(keys);
  }
  PyObject *out = PyDict_New();
  int64_t *p[N_TCOLS];
  if (!out) {
    free(eps);
    return NULL;
  }
  npy_intp dims[1] = {n};
  for (int k = 0; k < N_TCOLS; k++) {
    PyObject *a = PyArray_SimpleNew(1, dims, NPY_INT64);
    if (!a || PyDict_SetItemString(out, TCOL_NAMES[k], a) < 0) {
      Py_XDECREF(a);
      Py_DECREF(out);
      free(eps);
      return NULL;
    }
    p[k] = (int64_t *)PyArray_DATA((PyArrayObject *)a);
    Py_DECREF(a); /* the dict holds it */
  }
  for (int i = 0; i < n; i++) {
    CEp *e = eps[i];
    int k = 0;
    p[k++][i] = e->hid;
    p[k++][i] = e->local_port;
    p[k++][i] = e->remote_host;
    p[k++][i] = e->remote_port;
    p[k++][i] = e->state;
    p[k++][i] = e->cwnd;
    p[k++][i] = e->ssthresh;
    p[k++][i] = e->snd_nxt;
    p[k++][i] = e->snd_una;
    p[k++][i] = e->adv_wnd;
    p[k++][i] = e->buffered;
    p[k++][i] = e->bytes_acked;
    p[k++][i] = e->rto_backoff;
    p[k++][i] = e->retries;
    p[k++][i] = e->dup_acks;
    p[k++][i] = e->loss_events;
    p[k++][i] = e->cc_kind;
    p[k++][i] = e->in_recovery ? 1 : 0;
    p[k++][i] = e->recover;
    p[k++][i] = e->sack_high;
    p[k++][i] = e->w_max;
    p[k++][i] = e->epoch_start;
    p[k++][i] = e->sacked.count;
    p[k++][i] = e->rtx_done.count;
    p[k++][i] = e->rcv_nxt;
    p[k++][i] = e->ooo_bytes;
    p[k++][i] = e->bytes_received;
    p[k++][i] = e->last_wnd;
  }
  free(eps);
  return out;
}

/* the ADOPT_COLUMNS subset (devtransport.py twin) in writeback order */
#define N_TADOPT 7
static const char *TADOPT_NAMES[N_TADOPT] = {
    "cwnd", "ssthresh", "w_max", "epoch_start",
    "rto_backoff", "retries", "dup_acks"};

static PyObject *Core_adopt_transport_columns(CoreObject *c,
                                              PyObject *cols) {
  if (!PyDict_Check(cols)) {
    PyErr_SetString(PyExc_TypeError,
                    "adopt_transport_columns expects the column dict");
    return NULL;
  }
  PyObject *arrs[4 + N_TADOPT];
  const int64_t *dat[4 + N_TADOPT];
  const char *want[4 + N_TADOPT];
  for (int k = 0; k < 4; k++) want[k] = TCOL_NAMES[k]; /* identity join */
  for (int k = 0; k < N_TADOPT; k++) want[4 + k] = TADOPT_NAMES[k];
  Py_ssize_t n = -1;
  for (int k = 0; k < 4 + N_TADOPT; k++) {
    PyObject *a = PyDict_GetItemString(cols, want[k]);
    if (!a) {
      for (int j = 0; j < k; j++) Py_DECREF(arrs[j]);
      return PyErr_Format(PyExc_ValueError,
                          "adopt_transport_columns: missing column %s",
                          want[k]);
    }
    arrs[k] = PyArray_FROM_OTF(a, NPY_INT64, NPY_ARRAY_IN_ARRAY);
    if (!arrs[k]) {
      for (int j = 0; j < k; j++) Py_DECREF(arrs[j]);
      return NULL;
    }
    Py_ssize_t len = PyArray_SIZE((PyArrayObject *)arrs[k]);
    if (n < 0) n = len;
    if (len != n) {
      for (int j = 0; j <= k; j++) Py_DECREF(arrs[j]);
      return PyErr_Format(PyExc_ValueError,
                          "adopt_transport_columns: column %s length %zd"
                          " != %zd", want[k], len, n);
    }
    dat[k] = (const int64_t *)PyArray_DATA(
        (PyArrayObject *)arrs[k]);
  }
  /* two-pass validate-then-write: refusal must be ATOMIC (a partially
   * adopted cohort would be a state no snapshot ever described) */
  CEp **eps = malloc(sizeof(CEp *) * (size_t)(n ? n : 1));
  if (!eps) {
    for (int k = 0; k < 4 + N_TADOPT; k++) Py_DECREF(arrs[k]);
    return PyErr_NoMemory();
  }
  for (Py_ssize_t i = 0; i < n; i++) {
    int64_t hid = dat[0][i];
    CEp *e = NULL;
    if (hid >= 0 && hid < c->H && c->hs[hid].conns) {
      PyObject *key = Py_BuildValue("(LLL)", (long long)dat[1][i],
                                    (long long)dat[2][i],
                                    (long long)dat[3][i]);
      if (!key) goto fail;
      PyObject *v = PyDict_GetItem(c->hs[hid].conns, key);
      Py_DECREF(key);
      if (v && Py_TYPE(v) == &CEp_Type) e = (CEp *)v;
    }
    if (!e) {
      PyErr_Format(PyExc_ValueError,
                   "adopt_transport_columns: row %zd (host %lld port %lld"
                   ") names no live C endpoint", i, (long long)hid,
                   (long long)dat[1][i]);
      goto fail;
    }
    eps[i] = e;
  }
  for (Py_ssize_t i = 0; i < n; i++) {
    CEp *e = eps[i];
    e->cwnd = dat[4][i];
    e->ssthresh = dat[5][i];
    e->w_max = dat[6][i];
    e->epoch_start = dat[7][i];
    e->rto_backoff = dat[8][i];
    e->retries = (int)dat[9][i];
    e->dup_acks = (int)dat[10][i];
  }
  free(eps);
  for (int k = 0; k < 4 + N_TADOPT; k++) Py_DECREF(arrs[k]);
  Py_RETURN_NONE;
fail:
  free(eps);
  for (int k = 0; k < 4 + N_TADOPT; k++) Py_DECREF(arrs[k]);
  return NULL;
}

static PyObject *Core_adopt(CoreObject *c, PyObject *arg) {
  PyObject *seq = PySequence_Fast(
      arg, "adopt expects a sequence of restored C objects");
  if (!seq) return NULL;
  Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
  for (Py_ssize_t i = 0; i < n; i++) {
    PyObject *o = PySequence_Fast_GET_ITEM(seq, i);
    if (Py_TYPE(o) == &CEp_Type) {
      CEp *e = (CEp *)o;
      if (e->hid < 0 || e->hid >= c->H || e->remote_host < 0 ||
          e->remote_host >= c->H) {
        Py_DECREF(seq);
        PyErr_SetString(PyExc_ValueError,
                        "restored endpoint host id out of range");
        return NULL;
      }
      Py_INCREF(c);
      CoreObject *old = e->core;
      e->core = c;
      Py_XDECREF(old);
    } else if (Py_TYPE(o) == &GossipState_Type) {
      GossipState *g = (GossipState *)o;
      if (g->hid < 0 || g->hid >= c->H) {
        Py_DECREF(seq);
        PyErr_SetString(PyExc_ValueError,
                        "restored gossip host id out of range");
        return NULL;
      }
      CHost *h = &c->hs[g->hid];
      int have = 0;
      for (int j = 0; j < h->nports; j++)
        if (h->gs[j] == g) have = 1;
      if (!have) {
        if (h->nports >= 4) {
          Py_DECREF(seq);
          PyErr_SetString(PyExc_ValueError,
                          "too many C ports on one host (restore)");
          return NULL;
        }
        h->port[h->nports] = g->port;
        Py_INCREF(g);
        h->gs[h->nports] = g;
        h->nports++;
      }
      Py_INCREF(c);
      CoreObject *old = g->core;
      g->core = c;
      Py_XDECREF(old);
    } else if (Py_TYPE(o) == &CRelay_Type) {
      CRelayObj *r = (CRelayObj *)o;
      if (r->hid < 0 || r->hid >= c->H) {
        Py_DECREF(seq);
        PyErr_SetString(PyExc_ValueError,
                        "restored relay host id out of range");
        return NULL;
      }
      Py_INCREF(c);
      CoreObject *old = r->core;
      r->core = c;
      Py_XDECREF(old);
    }
    /* CBatch / TorSink / ExitStream carry no core pointer */
  }
  Py_DECREF(seq);
  Py_RETURN_NONE;
}

/* ---- module ------------------------------------------------------------ */
static PyObject *mod_unit_dropped(PyObject *self, PyObject *args) {
  (void)self;
  unsigned long long seed, uid;
  int npk;
  unsigned int th;
  if (!PyArg_ParseTuple(args, "KKiI", &seed, &uid, &npk, &th)) return NULL;
  return PyBool_FromLong(unit_dropped(seed, uid, npk, th));
}

static PyObject *mod_perf_dump(PyObject *self, PyObject *noarg) {
  (void)self; (void)noarg;
  PyObject *d = PyDict_New();
  const char *names[12] = {"_", "py_fallback", "gossip", "emit", "run_host",
                           "ctr_flush", "snapshot", "active_total",
                           "now_entry", "dispatch", "inbox_free", ""};
  for (int i = 0; i < 12; i++) {
    if (!tm_cnt[i] && !tm_sect[i]) continue;
    PyObject *v = Py_BuildValue("(dL)", tm_sect[i] / 1e9,
                                (long long)tm_cnt[i]);
    PyDict_SetItemString(d, names[i], v);
    Py_DECREF(v);
    tm_sect[i] = tm_cnt[i] = 0;
  }
  return d;
}

/* parse one packed cross-shard row block (parallel/shards.py wire
 * format: [n u64][numeric cols (n, 12) i64][payload lens (n,) i64]
 * [payload blobs]) straight into a CBatch — the packed ingest path that
 * keeps cross-shard arrivals off the Python tuple path entirely
 * (~26 us/row via tuples + _restore_state vs ~2 us here, measured at
 * the 100k-host tor scale). Payload blobs are marshal (len > 0) with a
 * pickle fallback (len < 0); len == 0 is None. */
static PyObject *mod_cbatch_from_packed(PyObject *self, PyObject *arg) {
  (void)self;
  Py_buffer view;
  if (PyObject_GetBuffer(arg, &view, PyBUF_SIMPLE) < 0) return NULL;
  const char *buf = view.buf;
  Py_ssize_t len = view.len;
  CBatch *cb = NULL;
  int bad = 0, err = 0;
  int64_t n = 0;
  if (len < 8) { bad = 1; goto done; }
  memcpy(&n, buf, 8);
  if (n < 0 || n > (len - 8) / (13 * 8)) { bad = 1; goto done; }
  cb = cbatch_new((int)n);
  if (!cb) { err = 1; goto done; }
  {
    const char *cols = buf + 8;
    const char *lens = buf + 8 + n * 12 * 8;
    Py_ssize_t off = 8 + n * 13 * 8;
    for (int64_t i = 0; i < n; i++) {
      int64_t r[12], ln;
      memcpy(r, cols + i * 12 * 8, 12 * 8);
      memcpy(&ln, lens + i * 8, 8);
      SRec *s = &cb->recs[i];
      s->t = r[0]; s->key = r[1]; s->tgt = (int32_t)r[2];
      s->kind = (int16_t)r[3]; s->peer = (int32_t)r[4];
      s->aport = (int32_t)r[5]; s->bport = (int32_t)r[6];
      s->nbytes = r[7]; s->seq = r[8]; s->frag = (int32_t)r[9];
      s->nfrags = (int32_t)r[10]; s->size = (int32_t)r[11];
      if (ln == 0) continue;
      int64_t alen = ln > 0 ? ln : -ln;
      if (off + alen > len) { bad = 1; goto done; }
      PyObject *p;
      if (ln > 0) {
        p = PyMarshal_ReadObjectFromString(buf + off, (Py_ssize_t)alen);
      } else {
        PyObject *pickle = PyImport_ImportModule("pickle");
        PyObject *blob = pickle ? PyBytes_FromStringAndSize(buf + off,
                                                            (Py_ssize_t)alen)
                                : NULL;
        p = blob ? PyObject_CallMethod(pickle, "loads", "O", blob) : NULL;
        Py_XDECREF(blob);
        Py_XDECREF(pickle);
      }
      if (!p) { err = 1; goto done; }
      cb->pay[i] = p; /* owned */
      off += alen;
    }
  }
done:
  PyBuffer_Release(&view);
  if (bad) {
    Py_XDECREF(cb);
    PyErr_SetString(PyExc_ValueError, "malformed packed batch");
    return NULL;
  }
  if (err) { Py_XDECREF(cb); return NULL; }
  return (PyObject *)cb;
}

static PyMethodDef module_methods[] = {
    {"cbatch_from_packed", mod_cbatch_from_packed, METH_O,
     "packed cross-shard row block (shards.py wire format) -> CBatch"},
    {"perf_dump", mod_perf_dump, METH_NOARGS, "drain section timers"},
    {"unit_dropped", mod_unit_dropped, METH_VARARGS,
     "(seed, uid, npk, thresh) -> bool  (test hook: fluid.loss_flags twin)"},
    {"shell", mod_shell, METH_O,
     "(type name) -> empty C object for checkpoint restore "
     "(filled via _restore_state; see shadow_tpu/checkpoint.py)"},
    {NULL, NULL, 0, NULL}};

static struct PyModuleDef colcore_module = {
    PyModuleDef_HEAD_INIT, "_colcore",
    "C fast path for the columnar data plane (see file docstring)", -1,
    module_methods, NULL, NULL, NULL, NULL};

PyMODINIT_FUNC PyInit__colcore(void) {
  import_array();
#define INTERN(var, s) \
  if (!(var = PyUnicode_InternFromString(s))) return NULL
  INTERN(S_id, "id");
  INTERN(S_now, "_now");
  INTERN(S_inbox, "_inbox");
  INTERN(S_egress_rows, "egress_rows");
  INTERN(S_uid_counter, "_uid_counter");
  INTERN(S_emitters, "emitters");
  INTERN(S_ev_key, "_ev_key");
  INTERN(S_min_used_latency, "min_used_latency");
  INTERN(S_units_sent, "units_sent");
  INTERN(S_units_dropped, "units_dropped");
  INTERN(S_units_blackholed, "units_blackholed");
  INTERN(S_bytes_sent, "bytes_sent");
  INTERN(S_device, "device");
  INTERN(S_device_floor, "device_floor");
  INTERN(S_rows, "rows");
  INTERN(S_pos, "pos");
  INTERN(S_dispatch_row, "dispatch_row");
  INTERN(S_run_events, "run_events");
  INTERN(S_popleft, "popleft");
  INTERN(S_append, "append");
  INTERN(S_ingress_deferred_rows, "ingress_deferred_rows");
  INTERN(S_pcap, "pcap");
  INTERN(S_n_emitted, "_n_emitted");
  INTERN(S_n_delivered, "_n_delivered");
  INTERN(S_n_dgrams, "_n_dgrams");
  INTERN(S_n_dgrams_recv, "_n_dgrams_recv");
  INTERN(S_n_events, "_n_events");
  INTERN(S_n_teardown, "_n_teardown");
  INTERN(S_n_blackholed, "_n_blackholed");
  INTERN(S_down, "down");
  INTERN(S_cc_id, "cc_id");
  INTERN(S_seed, "seed");
  INTERN(S_bootstrap_end, "bootstrap_end");
  INTERN(S_unit_chunk, "unit_chunk");
  INTERN(S_socket_send_buffer, "socket_send_buffer");
  INTERN(S_socket_recv_buffer, "socket_recv_buffer");
  INTERN(S_dispatch, "dispatch");
  INTERN(S_schedule_in, "schedule_in");
  INTERN(S_cancel_m, "cancel");
  INTERN(S_rto_fire, "_rto_fire");
  INTERN(S_syn_fire, "_syn_fire");
  INTERN(S_fin_fire, "_fin_fire");
  INTERN(S_drop_fire, "_drop_fire");
  INTERN(S_idle_fire, "_idle_fire");
  INTERN(S_seq_ctr, "_seq");
  INTERN(S_on_first, "on_first");
#undef INTERN
  O_zero = PyLong_FromLong(0);
  O_one = PyLong_FromLong(1);
  O_false = Py_False;
  Py_INCREF(O_false);
  O_kind_dgram = PyLong_FromLong(KIND_DGRAM);
  if (!O_zero || !O_one || !O_kind_dgram) return NULL;
  if (PyType_Ready(&Core_Type) < 0 || PyType_Ready(&GossipState_Type) < 0
      || PyType_Ready(&CEp_Type) < 0 || PyType_Ready(&CRelay_Type) < 0
      || PyType_Ready(&CBatch_Type) < 0
      || PyType_Ready(&CTorSink_Type) < 0
      || PyType_Ready(&CExitStream_Type) < 0)
    return NULL;
  PyObject *m = PyModule_Create(&colcore_module);
  if (!m) return NULL;
  /* checkpoint state-format fingerprint (shadow_tpu/checkpoint.py): a
   * checkpoint carrying C-engine state records this value in its header
   * and loading refuses a mismatch by name. Bump on ANY change to the
   * _export_state/_restore_state layouts. */
  /* ABI 3 (PR 9): CEp grew the SACK scoreboard + congestion-control
   * seam (cc_kind, w_max/epoch_start, in_recovery/recover/sack_high,
   * sacked/rtx_done seq sets) in _export_state and the fingerprint —
   * ABI-2 checkpoints restore the wrong field count and must refuse by
   * name. (ABI 2 was the uid canonical-event-key change.)
   * ABI 4 (PR 11): the transport column snapshot/adopt surface
   * (Core.transport_columns / adopt_transport_columns) joined the
   * state contract, paired with checkpoint VERSION 4 (the Python
   * StreamSender scoreboards became sorted lists — the canonical form
   * both column exports and CEp's sorted-tuple export already used). */
  PyModule_AddIntConstant(m, "ABI", 4);
  Py_INCREF(&Core_Type);
  PyModule_AddObject(m, "Core", (PyObject *)&Core_Type);
  Py_INCREF(&GossipState_Type);
  PyModule_AddObject(m, "GossipState", (PyObject *)&GossipState_Type);
  Py_INCREF(&CEp_Type);
  PyModule_AddObject(m, "Endpoint", (PyObject *)&CEp_Type);
  Py_INCREF(&CRelay_Type);
  PyModule_AddObject(m, "Relay", (PyObject *)&CRelay_Type);
  return m;
}
