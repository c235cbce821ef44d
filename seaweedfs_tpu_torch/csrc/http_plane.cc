// Native volume-server data plane (reads + plain writes).
//
// The reference's data plane is Go: goroutine-per-connection HTTP serving
// needle reads straight off the volume files (reference
// weed/server/volume_server_handlers_read.go) and plain needle writes
// appended under a per-volume lock (volume_server_handlers_write.go:18,
// topology/store_replicate.go:20-83). The Python server keeps full
// semantics but serves one request at a time under the GIL; this
// library is the native equivalent of the reference's hot
// loops: a thread-per-connection keep-alive HTTP/1.1 server that parses
// `GET|POST /<vid>,<fid>`, serves reads from an in-process index mirror
// (synced from Python over ctypes), and — for volumes Python has handed
// the write lease to — parses multipart uploads, builds the needle
// record, appends .dat + .idx under a per-volume mutex, and updates the
// mirror, all without Python in the loop.
//
// WRITE OWNERSHIP. While a volume's writer is enabled, this library is
// the SINGLE writer of that volume's .dat and .idx tails: Python's own
// write/delete paths delegate their appends through swhp_append (the
// same mutex), and structural operations (compaction commit, copy,
// tail-receive) first disable the writer — a mutex-barrier handback —
// then reload their needle map from the .idx this library kept
// authoritative. The index mirror is therefore exact (not best-effort)
// in writer mode, and Python consults it as the source of truth.
//
// Scope is the FAST PATH only. Anything with semantics beyond a plain
// stored needle — gzip-stored payloads, chunk manifests, Seaweed-* pair
// headers, image resize queries, EC volumes, remote volumes, query
// params (?ttl, ?cm, ?ts, replication hops), JWT-guarded or replicated
// writes — is answered with a 307 redirect to the Python server
// (`fallback`), which remains the source of truth. Correctness parity
// for the served cases is pinned by tests/test_torch_native_plane.py
// against the Python server's responses.
//
// Needle layout parsed here == storage/needle.py (byte-compatible with
// reference weed/storage/needle/needle_read_write.go):
//   header: Cookie(4) Id(8) Size(4) big-endian
//   v2/v3 body: DataSize(4) Data Flags(1) [Name] [Mime] [LastModified(5)]
//               [TTL(2)] [PairsSize(2) Pairs] CRC(4) [AppendAtNs(8)] pad8
// CRC is masked Castagnoli over Data (reference crc.go:25).

#include <arpa/inet.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/resource.h>
#include <sys/socket.h>
#include <sys/syscall.h>
#include <sys/types.h>
#include <sys/uio.h>
#include <unistd.h>

#include <algorithm>
#include <atomic>
#include <cerrno>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <ctime>
#include <deque>
#include <list>
#include <memory>
#include <mutex>
#include <shared_mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <unordered_set>
#include <vector>

#include <fcntl.h>

namespace {

// ---------------------------------------------------------------- crc32c
struct CrcTables {
  uint32_t t[8][256];
  CrcTables() {
    const uint32_t poly = 0x82F63B78u;
    for (uint32_t i = 0; i < 256; i++) {
      uint32_t c = i;
      for (int k = 0; k < 8; k++) c = (c & 1) ? (c >> 1) ^ poly : c >> 1;
      t[0][i] = c;
    }
    for (int j = 1; j < 8; j++)
      for (uint32_t i = 0; i < 256; i++)
        t[j][i] = t[j - 1][i] >> 8 ^ t[0][t[j - 1][i] & 0xFF];
  }
};
const CrcTables g_crc;

uint32_t crc32c(const uint8_t* data, size_t n) {
  uint32_t crc = ~0u;
  size_t i = 0;
  for (; i + 8 <= n; i += 8) {
    crc ^= static_cast<uint32_t>(data[i]) |
           (static_cast<uint32_t>(data[i + 1]) << 8) |
           (static_cast<uint32_t>(data[i + 2]) << 16) |
           (static_cast<uint32_t>(data[i + 3]) << 24);
    crc = g_crc.t[7][crc & 0xFF] ^ g_crc.t[6][(crc >> 8) & 0xFF] ^
          g_crc.t[5][(crc >> 16) & 0xFF] ^ g_crc.t[4][crc >> 24] ^
          g_crc.t[3][data[i + 4]] ^ g_crc.t[2][data[i + 5]] ^
          g_crc.t[1][data[i + 6]] ^ g_crc.t[0][data[i + 7]];
  }
  for (; i < n; i++) crc = g_crc.t[0][(crc ^ data[i]) & 0xFF] ^ (crc >> 8);
  return ~crc;
}

uint32_t masked_crc(uint32_t crc) {  // reference crc.go:25
  return ((crc >> 15) | (crc << 17)) + 0xA282EAD8u;
}

// --------------------------------------------------------------- needles
constexpr int kHeaderSize = 16;
constexpr int kChecksumSize = 4;
constexpr int kTimestampSize = 8;
constexpr int kPaddingSize = 8;
constexpr uint32_t kTombstoneSize = 0xFFFFFFFFu;

constexpr uint8_t kFlagGzip = 0x01;
constexpr uint8_t kFlagHasName = 0x02;
constexpr uint8_t kFlagHasMime = 0x04;
constexpr uint8_t kFlagHasLastModified = 0x08;
constexpr uint8_t kFlagHasTtl = 0x10;
constexpr uint8_t kFlagHasPairs = 0x20;
constexpr uint8_t kFlagChunkManifest = 0x80;

uint64_t be64(const uint8_t* p) {
  uint64_t v = 0;
  for (int i = 0; i < 8; i++) v = v << 8 | p[i];
  return v;
}
uint32_t be32(const uint8_t* p) {
  return static_cast<uint32_t>(p[0]) << 24 | static_cast<uint32_t>(p[1]) << 16 |
         static_cast<uint32_t>(p[2]) << 8 | p[3];
}

int64_t actual_size(uint32_t size, int version) {
  int64_t base = kHeaderSize + static_cast<int64_t>(size) + kChecksumSize;
  if (version == 3) base += kTimestampSize;
  // reference PaddingLength never returns 0 (needle_read_write.go:287)
  return base + (kPaddingSize - base % kPaddingSize);
}

// minutes per TTL unit (storage/types.py _UNIT_MINUTES)
int64_t ttl_minutes(uint8_t count, uint8_t unit) {
  static const int64_t per[] = {0, 1, 60, 1440, 10080, 44640, 525600};
  return unit < 7 ? count * per[unit] : 0;
}

struct ParsedNeedle {
  uint32_t cookie = 0;
  uint64_t id = 0;
  uint32_t size = 0;
  const uint8_t* data = nullptr;  // into the read buffer
  uint32_t data_size = 0;
  uint8_t flags = 0;
  std::string name, mime;
  int64_t last_modified = 0;  // unix seconds
  uint8_t ttl_count = 0, ttl_unit = 0;
  uint32_t checksum = 0;  // stored masked crc
};

// Returns 0 ok, -1 corrupt.
int parse_needle(const uint8_t* blob, size_t len, int version,
                 ParsedNeedle* out) {
  if (len < kHeaderSize) return -1;
  out->cookie = be32(blob);
  out->id = be64(blob + 4);
  out->size = be32(blob + 12);
  size_t size = out->size;
  if (kHeaderSize + size + kChecksumSize > len) return -1;
  const uint8_t* b = blob + kHeaderSize;
  if (version == 1) {
    out->data = b;
    out->data_size = out->size;
    out->flags = 0;
  } else {
    // v2/v3 body of `size` bytes
    size_t idx = 0;
    if (size > 0) {
      if (idx + 4 > size) return -1;
      out->data_size = be32(b + idx);
      idx += 4;
      if (idx + out->data_size >= size) return -1;  // flags byte must follow
      out->data = b + idx;
      idx += out->data_size;
      out->flags = b[idx++];
    }
    if (idx < size && (out->flags & kFlagHasName)) {
      uint8_t n = b[idx++];
      if (idx + n > size) return -1;
      out->name.assign(reinterpret_cast<const char*>(b + idx), n);
      idx += n;
    }
    if (idx < size && (out->flags & kFlagHasMime)) {
      uint8_t n = b[idx++];
      if (idx + n > size) return -1;
      out->mime.assign(reinterpret_cast<const char*>(b + idx), n);
      idx += n;
    }
    if (idx < size && (out->flags & kFlagHasLastModified)) {
      if (idx + 5 > size) return -1;
      int64_t v = 0;
      for (int i = 0; i < 5; i++) v = v << 8 | b[idx + i];
      out->last_modified = v;
      idx += 5;
    }
    if (idx < size && (out->flags & kFlagHasTtl)) {
      if (idx + 2 > size) return -1;
      out->ttl_count = b[idx];
      out->ttl_unit = b[idx + 1];
      idx += 2;
    }
  }
  out->checksum = be32(b + size);
  return 0;
}

// ---------------------------------------------------------------- server
struct Server;

// One group-commit rider whose HTTP ack the committer sends after the
// covering fdatasync: holds a dup of the connection fd (owned — closed
// on destruction), the pre-built 200 response, and a 307 fallback for
// the poison path. t0_us/bytes/target feed per-request telemetry; t0_us
// is 0 when stats were off at request start (clock-free discipline).
struct DeferredAck {
  int fd = -1;
  uint64_t seq = 0;
  std::string resp;      // full HTTP bytes of the success ack
  std::string fallback;  // full HTTP bytes of the 307 poison redirect
  uint64_t t0_us = 0;
  uint64_t bytes = 0;
  std::string target;
  DeferredAck() = default;
  DeferredAck(const DeferredAck&) = delete;
  DeferredAck& operator=(const DeferredAck&) = delete;
  DeferredAck(DeferredAck&& o) noexcept { *this = std::move(o); }
  DeferredAck& operator=(DeferredAck&& o) noexcept {
    if (this == &o) return *this;
    if (fd >= 0) close(fd);
    fd = o.fd;
    o.fd = -1;
    seq = o.seq;
    resp = std::move(o.resp);
    fallback = std::move(o.fallback);
    t0_us = o.t0_us;
    bytes = o.bytes;
    target = std::move(o.target);
    return *this;
  }
  ~DeferredAck() {
    if (fd >= 0) close(fd);
  }
};

// Write lease for one volume: fds + append offset + counter deltas.
// While enabled, every .dat/.idx append (fast-path POSTs AND Python's
// delegated writes via swhp_append) serializes on `mu`; disabling takes
// `mu`, so after swhp_disable_writer returns no append is in flight.
struct Writer {
  int fd = -1;      // O_RDWR on the .dat (appends via pwrite at tail)
  int idx_fd = -1;  // O_APPEND on the .idx
  std::mutex mu;
  std::atomic<bool> accept_posts{false};  // fast-path POSTs allowed
  // tail is written under mu; atomic so counter reads stay lock-free
  std::atomic<int64_t> tail{0};
  int64_t idx_tail = 0;     // .idx size (for torn-entry truncation)
  int offset_width = 4;     // 4 (32GB) or 5 (8TB) — .idx record width
  int64_t max_size = 0;     // addressing ceiling for this offset width
  int64_t file_size_limit = 0;  // per-upload data cap (0 = unlimited)
  // counter deltas since enable, mirroring NeedleMap._apply
  // (storage/needle_map.py:85): Python adds these to its (frozen)
  // needle-map counters for heartbeats while the lease is out
  std::atomic<uint64_t> puts{0}, put_bytes{0};
  std::atomic<uint64_t> deletes{0}, deleted_bytes{0};
  std::atomic<uint64_t> max_key{0};

  // -- group-commit durability (SW_PLANE_FSYNC_MODE). In group mode a
  // dedicated committer amortizes ONE fdatasync over every append that
  // landed inside the commit window; an append is acked only after the
  // fdatasync covering its sequence number returned. `sync_mu` is the
  // INNER lock (taken with `mu` held to publish a sequence, and alone
  // by the committer/waiters — the committer never takes `mu`).
  int sync_mode = 0;        // 0 off, 1 group, 2 always; frozen at enable
  uint64_t batch_us = 2000;     // commit window (SW_PLANE_FSYNC_BATCH_US)
  uint64_t max_pending = 512;   // riders forcing an early commit
  Server* srv = nullptr;        // telemetry sink (server-global counters)
  int sync_dat_fd = -1, sync_idx_fd = -1;  // committer's dup'd fds
  std::mutex sync_mu;
  std::condition_variable sync_cv;  // wakes the committer
  // riders wait on the cv matching their batch's parity, so a commit
  // wakes only its own cohort — one shared cv would spuriously wake
  // (and context-switch) every rider of the batch still accumulating
  std::condition_variable ack_cv[2];
  // Deferred acks: the common-case rider doesn't block at all — it
  // leaves a pre-built response (and a poison fallback) with the
  // committer, which sends it once the covering fdatasync returns.
  // Owns a dup of the connection fd so the conn thread's own
  // lifecycle (close on hangup/non-keepalive) can't race the send.
  std::deque<DeferredAck> deferred;  // seq-ordered, under sync_mu
  uint64_t sync_gen = 0;     // open commit generation (under sync_mu)
  uint64_t append_seq = 0;   // last sequence appended (under mu+sync_mu)
  uint64_t synced_seq = 0;   // last sequence covered by an fdatasync
  bool sync_failed = false;  // poisoned: an fdatasync failed — fail-stop
  bool committer_stop = false;
  std::thread committer;

  // Idempotent committer teardown: the committer drains every pending
  // sequence with a FINAL fdatasync before exiting, so appends enqueued
  // before the stop get durable acks rather than hanging; appends that
  // arrive after see committer_stop and poison themselves (-5).
  void stop_committer() {
    {
      std::lock_guard<std::mutex> sg(sync_mu);
      committer_stop = true;
      sync_cv.notify_all();
    }
    if (committer.joinable()) committer.join();
  }

  ~Writer() {
    stop_committer();
    // the committer closes its dups at loop exit; these remain only
    // when enable failed before the thread spawned
    if (sync_dat_fd >= 0) close(sync_dat_fd);
    if (sync_idx_fd >= 0) close(sync_idx_fd);
    if (fd >= 0) close(fd);
    if (idx_fd >= 0) close(idx_fd);
  }
};

struct VolumeRec {
  int fd = -1;
  int version = 3;
  std::string dat_path;
  std::unordered_map<uint64_t, std::pair<uint64_t, uint32_t>> index;
  std::shared_ptr<Writer> writer;  // guarded by mu (shared: read lock)
  mutable std::shared_mutex mu;
  ~VolumeRec() {
    if (fd >= 0) close(fd);
  }
  std::shared_ptr<Writer> get_writer() const {
    std::shared_lock<std::shared_mutex> l(mu);
    return writer;
  }
};

// ------------------------------------------------------------ EC volumes
// Mirror of an EC-mounted volume: the .ecx needle index (key ->
// (dat offset, size)) plus the striping geometry (ec/locate.py) so a
// needle's logical .dat range maps to (shard id, offset in shard file)
// without Python in the loop. Locally-held data shards are read straight
// from their files; a lost shard's bytes come from the reconstructed-slab
// cache below — if every covering slab is resident the GET never leaves
// the plane.
constexpr int kDataShards = 10;   // ec/constants.py DATA_SHARDS
constexpr int kMaxEcShards = 32;  // data+parity ceiling (codec max)

struct EcVolumeRec {
  int version = 3;
  int64_t dat_size = 0;  // original .dat size (drives the row split)
  int64_t large_block = 0, small_block = 0;
  int64_t slab_bytes = 0;  // cache slab size (SW_EC_DEGRADED_SLAB_BYTES)
  int shard_fds[kMaxEcShards];  // -1 = shard not local (lost or remote)
  std::unordered_map<uint64_t, std::pair<uint64_t, uint32_t>> index;
  mutable std::shared_mutex mu;  // guards index + shard_fds
  EcVolumeRec() {
    for (int i = 0; i < kMaxEcShards; i++) shard_fds[i] = -1;
  }
  ~EcVolumeRec() {
    for (int i = 0; i < kMaxEcShards; i++)
      if (shard_fds[i] >= 0) close(shard_fds[i]);
  }
};

// encoder-exact large-row count (ec/locate.py n_large_rows_for)
int64_t ec_n_large_rows(int64_t dat_size, int64_t large_block) {
  if (dat_size <= 0) return 0;
  return (dat_size - 1) / (large_block * kDataShards);
}

// ------------------------------------------------------------ slab cache
// Byte-budgeted LRU of reconstructed slabs, keyed (vid, sid, slab index),
// fed from Python (swhp_cache_put publishes what DegradedReadEngine just
// reconstructed) and invalidated on mount/rebuild. One plain mutex guards
// the map, the recency list AND the counters: the counters must be exact
// (tests hammer put/invalidate under concurrent reads and assert totals),
// and the critical sections are tiny — values are shared_ptrs, so readers
// copy outside the lock and an invalidate can never tear an in-flight
// read.
struct SlabKey {
  uint64_t vs;  // vid << 32 | sid
  uint64_t idx;
  bool operator==(const SlabKey& o) const {
    return vs == o.vs && idx == o.idx;
  }
};
struct SlabKeyHash {
  size_t operator()(const SlabKey& k) const {
    uint64_t x = (k.vs ^ (k.idx * 0x9E3779B97F4A7C15ull)) + k.idx;
    x ^= x >> 33;
    x *= 0xFF51AFD7ED558CCDull;
    x ^= x >> 33;
    return static_cast<size_t>(x);
  }
};

struct SlabCache {
  mutable std::mutex mu;
  using Entry = std::pair<SlabKey, std::shared_ptr<std::vector<uint8_t>>>;
  std::list<Entry> lru;  // MRU at front
  std::unordered_map<SlabKey, std::list<Entry>::iterator, SlabKeyHash> map;
  uint64_t max_bytes = 0;  // 0 = cache disabled
  uint64_t bytes = 0;
  uint64_t puts = 0, put_bytes = 0, hits = 0, misses = 0, evictions = 0,
           invalidated = 0;

  // callers hold mu
  void evict_to_budget() {
    while (bytes > max_bytes && !lru.empty()) {
      Entry& tail = lru.back();
      bytes -= tail.second->size();
      map.erase(tail.first);
      lru.pop_back();
      evictions++;
    }
  }
};

// ------------------------------------------------------------- telemetry
// Request telemetry for the hot path: plain relaxed atomics on the fast
// path (one cache line of fetch_adds per request, no locks), a
// fixed-bucket latency histogram in µs, and a bounded slow-request ring
// whose mutex is taken only when a request crosses the slow threshold.
// The µs bucket bounds must cover both the in-memory hit (~tens of µs)
// and a degraded/redirected tail (seconds); the Python side reads them
// via swhp_lat_bounds so the two never drift.
constexpr uint64_t kLatBoundsUs[] = {50,     100,    250,    500,
                                     1000,   2500,   5000,   10000,
                                     25000,  50000,  100000, 250000,
                                     1000000, 5000000};
constexpr int kLatBuckets =
    static_cast<int>(sizeof(kLatBoundsUs) / sizeof(kLatBoundsUs[0]));
constexpr int kSlowRing = 64;

struct SlowEntry {
  char method[8] = {0};
  char target[96] = {0};
  int status = 0;
  uint64_t bytes = 0;
  uint64_t micros = 0;
  uint64_t unix_ms = 0;
};

struct PlaneStats {
  std::atomic<bool> enabled{true};
  std::atomic<uint64_t> slow_us{10000};
  std::atomic<uint64_t> requests{0};
  std::atomic<uint64_t> by_class[6] = {};  // [1..5] = 1xx..5xx
  std::atomic<uint64_t> bytes_sent{0};
  std::atomic<uint64_t> index_misses{0};
  std::atomic<uint64_t> lat_count{0};
  std::atomic<uint64_t> lat_sum_us{0};
  std::atomic<uint64_t> lat_buckets[kLatBuckets + 1] = {};  // +1: overflow
  std::mutex slow_mu;
  SlowEntry slow[kSlowRing];
  uint64_t slow_seq = 0;  // total slow entries ever; guarded by slow_mu
};

// Handlers funnel their response through respond_simple (or write the
// 200/206 head themselves); these thread-locals carry status+payload
// size back to handle_conn's per-request record without threading an
// out-param through every serve_* signature. Thread-per-connection
// makes them race-free.
thread_local int tl_status = 0;
thread_local uint64_t tl_bytes = 0;
// group-commit deferral: serve_write sets tl_deferred when it handed
// its ack to the committer (handle_conn must not record telemetry —
// the committer records the full request latency at send time); tl_t0
// carries the request clock start into the deferred entry (0 when the
// stats were off at request start)
thread_local bool tl_deferred = false;
thread_local uint64_t tl_t0 = 0;

uint64_t mono_us() {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return static_cast<uint64_t>(ts.tv_sec) * 1000000ull +
         static_cast<uint64_t>(ts.tv_nsec) / 1000;
}

uint64_t wall_ms() {
  struct timespec ts;
  clock_gettime(CLOCK_REALTIME, &ts);
  return static_cast<uint64_t>(ts.tv_sec) * 1000ull +
         static_cast<uint64_t>(ts.tv_nsec) / 1000000;
}

struct Server {
  int listen_fd = -1;
  uint16_t port = 0;
  std::string fallback;  // host:port of the Python server
  std::atomic<bool> stop{false};
  std::atomic<uint64_t> served{0}, redirected{0}, errors{0};
  std::atomic<uint64_t> written{0};  // fast-path POSTs appended here
  std::atomic<int> live{0};
  // open connection sockets: stop shuts them down, so a thread waiting
  // on an idle keep-alive connection returns at once (closed under the
  // same mutex, so a shut-down fd is never one reused since)
  std::mutex conns_mu;
  std::unordered_set<int> conns;
  int max_conns = 1024;
  int64_t max_fastpath_bytes = 64ll << 20;
  std::thread acceptor;
  std::unordered_map<uint32_t, std::shared_ptr<VolumeRec>> vols;
  mutable std::shared_mutex vols_mu;
  PlaneStats stats;
  std::unordered_map<uint32_t, std::shared_ptr<EcVolumeRec>> ec_vols;
  mutable std::shared_mutex ec_mu;
  SlabCache cache;
  // EC serving outcomes, bumped BEFORE the response bytes leave (same
  // rule as `served`): degraded = at least one lost-shard byte came from
  // the slab cache; local = all shards were local files.
  std::atomic<uint64_t> ec_degraded_served{0};
  std::atomic<uint64_t> ec_degraded_redirected{0};
  std::atomic<uint64_t> ec_local_served{0};

  // group-commit durability config (swhp_set_sync_mode; applied to
  // writers at enable time so a live lease's mode never mutates under
  // in-flight appends) + server-global telemetry across all writers.
  // The fsync µs histogram reuses kLatBoundsUs and is populated only
  // while stats are enabled (SW_PLANE_STATS=0 keeps the committer
  // clock-free too).
  std::atomic<int> sync_mode{0};
  std::atomic<uint64_t> sync_batch_us{2000};
  std::atomic<uint64_t> sync_max_pending{512};
  std::atomic<uint64_t> fsync_batches{0};
  std::atomic<uint64_t> fsync_riders{0};
  std::atomic<uint64_t> fsync_failures{0};
  std::atomic<uint64_t> fsync_pending{0};
  std::atomic<uint64_t> fsync_us_sum{0};
  std::atomic<uint64_t> fsync_buckets[kLatBuckets + 1] = {};

  std::shared_ptr<VolumeRec> find(uint32_t vid) const {
    std::shared_lock<std::shared_mutex> l(vols_mu);
    auto it = vols.find(vid);
    return it == vols.end() ? nullptr : it->second;
  }
  std::shared_ptr<EcVolumeRec> find_ec(uint32_t vid) const {
    std::shared_lock<std::shared_mutex> l(ec_mu);
    auto it = ec_vols.find(vid);
    return it == ec_vols.end() ? nullptr : it->second;
  }
};

// ----------------------------------------------------- group commit
// One committed batch's telemetry. The µs histogram (kLatBoundsUs) and
// sum are skipped when the batch wasn't timed — SW_PLANE_STATS=0 keeps
// even the committer clock-free; batch/rider counts are plain
// fetch_adds and always flow.
void record_fsync(Server* s, uint64_t riders, uint64_t us, bool timed) {
  s->fsync_batches.fetch_add(1, std::memory_order_relaxed);
  s->fsync_riders.fetch_add(riders, std::memory_order_relaxed);
  if (!timed) return;
  s->fsync_us_sum.fetch_add(us, std::memory_order_relaxed);
  int b = 0;
  while (b < kLatBuckets && us > kLatBoundsUs[b]) b++;
  s->fsync_buckets[b].fetch_add(1, std::memory_order_relaxed);
}

// Flush deferred group-commit acks outside any writer lock: a clean
// commit sends each rider its pre-built 200; a poison/teardown sends
// the 307 fallback (durability unknown — the record was never acked,
// so the client's retry through Python is a harmless duplicate).
// Defined after record_request; used by the committer and poison.
void send_deferred(Server* s, std::vector<DeferredAck> acks, bool ok);

// Fail-stop a writer after an fdatasync error: acking a write whose
// durability is unknown is the one unforgivable ambiguity, so the whole
// batch poisons (-5 to every waiter) and the writer dies like the
// torn-.idx path in do_append — Python demotes to its own append path
// and the next lease cycle resumes from the consistent prefix. Caller
// must hold NEITHER w->mu nor w->sync_mu.
void poison_writer(Writer* w) {
  std::vector<DeferredAck> orphans;
  {
    std::lock_guard<std::mutex> sg(w->sync_mu);
    w->sync_failed = true;
    w->ack_cv[0].notify_all();
    w->ack_cv[1].notify_all();
    while (!w->deferred.empty()) {
      orphans.push_back(std::move(w->deferred.front()));
      w->deferred.pop_front();
    }
  }
  if (!orphans.empty())
    send_deferred(w->srv, std::move(orphans), false);
  w->accept_posts.store(false, std::memory_order_release);
  std::lock_guard<std::mutex> g(w->mu);
  if (w->fd >= 0) close(w->fd);
  if (w->idx_fd >= 0) close(w->idx_fd);
  w->fd = w->idx_fd = -1;
}

// The group-commit committer: waits for the first rider, lets the
// commit window (batch_us) fill — or max_pending riders force an early
// close — then issues ONE fdatasync pair (.dat then .idx) covering
// every sequence appended before the sync started, advances synced_seq
// and wakes the batch. The fds are private dups, so a concurrent
// fail-stop closing the writer's fds can't invalidate an in-flight
// fdatasync; appends racing in DURING the sync simply ride the next
// batch (fdatasync may flush their bytes early — never the reverse).
void committer_loop(Server* s, Writer* w) {
  // every in-flight durable write waits on this thread: under load the
  // committer competes with hundreds of runnable conn threads for the
  // CPU, and each scheduling delay stretches the commit cycle for the
  // whole batch — ask for priority (best-effort: may need privileges)
  setpriority(PRIO_PROCESS,
              static_cast<id_t>(syscall(SYS_gettid)), -10);
  std::unique_lock<std::mutex> sl(w->sync_mu);
  for (;;) {
    w->sync_cv.wait(sl, [&] {
      return w->committer_stop ||
             (w->append_seq > w->synced_seq && !w->sync_failed);
    });
    if (w->committer_stop &&
        (w->append_seq == w->synced_seq || w->sync_failed))
      break;
    uint64_t first = w->synced_seq;
    if (!w->committer_stop && w->batch_us > 0)
      w->sync_cv.wait_for(
          sl, std::chrono::microseconds(w->batch_us), [&] {
            return w->committer_stop ||
                   w->append_seq - first >= w->max_pending;
          });
    uint64_t upto = w->append_seq;
    // close the open batch: riders that enqueued while sync_gen == gen
    // are exactly the sequences <= upto (both read under sync_mu)
    uint64_t gen = w->sync_gen++;
    sl.unlock();
    bool timed = s->stats.enabled.load(std::memory_order_relaxed);
    uint64_t t0 = timed ? mono_us() : 0;
    // sync .dat and .idx concurrently: issued back-to-back each forces
    // its own journal commit; in flight together the jbd2 layer merges
    // them into one transaction, roughly halving the commit window
    bool idx_ok = false;
    std::thread idx_sync(
        [&] { idx_ok = fdatasync(w->sync_idx_fd) == 0; });
    bool dat_ok = fdatasync(w->sync_dat_fd) == 0;
    idx_sync.join();
    bool ok = dat_ok && idx_ok;
    uint64_t us = timed ? mono_us() - t0 : 0;
    if (ok) {
      record_fsync(s, upto - first, us, timed);
      sl.lock();
      w->synced_seq = upto;
      w->ack_cv[gen & 1].notify_all();
      if (!w->deferred.empty() && w->deferred.front().seq <= upto) {
        std::vector<DeferredAck> acks;
        while (!w->deferred.empty() && w->deferred.front().seq <= upto) {
          acks.push_back(std::move(w->deferred.front()));
          w->deferred.pop_front();
        }
        sl.unlock();  // sends must not block riders enqueueing
        send_deferred(s, std::move(acks), true);
        sl.lock();
      }
    } else {
      s->fsync_failures.fetch_add(1, std::memory_order_relaxed);
      poison_writer(w);
      sl.lock();
    }
  }
  // belt-and-braces: a rider enqueued after sync_failed is rejected
  // with -5 before it defers, and poison flushed the queue — but a
  // deferred ack must never be silently dropped, so fall back loudly
  std::vector<DeferredAck> leftover;
  while (!w->deferred.empty()) {
    leftover.push_back(std::move(w->deferred.front()));
    w->deferred.pop_front();
  }
  sl.unlock();
  if (!leftover.empty())
    send_deferred(s, std::move(leftover), false);
  close(w->sync_dat_fd);
  close(w->sync_idx_fd);
  w->sync_dat_fd = w->sync_idx_fd = -1;
}

bool send_all(int fd, const void* buf, size_t n) {
  const char* p = static_cast<const char*>(buf);
  while (n > 0) {
    ssize_t w = send(fd, p, n, MSG_NOSIGNAL);
    if (w <= 0) return false;
    p += w;
    n -= static_cast<size_t>(w);
  }
  return true;
}

// header+body in one syscall (syscalls dominate small-needle serving)
bool send_two(int fd, const void* a, size_t an, const void* b, size_t bn) {
  struct iovec iov[2] = {{const_cast<void*>(a), an},
                         {const_cast<void*>(b), bn}};
  size_t idx = 0;
  while (idx < 2) {
    ssize_t w = writev(fd, iov + idx, static_cast<int>(2 - idx));
    if (w <= 0) return false;
    size_t done = static_cast<size_t>(w);
    while (idx < 2 && done >= iov[idx].iov_len) {
      done -= iov[idx].iov_len;
      idx++;
    }
    if (idx < 2 && done > 0) {
      iov[idx].iov_base = static_cast<char*>(iov[idx].iov_base) + done;
      iov[idx].iov_len -= done;
    }
  }
  return true;
}

struct Request {
  std::string method, target;
  bool keepalive = true;
  bool http10 = false;
  std::string if_none_match, range, if_modified_since;
  std::string content_type;
  int64_t content_length = 0;
  bool chunked = false;
  bool has_pair_headers = false;  // any Seaweed-* header present
};

void record_request(Server* s, const Request& req, int status,
                    uint64_t bytes, uint64_t us) {
  PlaneStats& st = s->stats;
  st.requests.fetch_add(1, std::memory_order_relaxed);
  int cls = status / 100;
  if (cls >= 1 && cls <= 5)
    st.by_class[cls].fetch_add(1, std::memory_order_relaxed);
  st.bytes_sent.fetch_add(bytes, std::memory_order_relaxed);
  st.lat_count.fetch_add(1, std::memory_order_relaxed);
  st.lat_sum_us.fetch_add(us, std::memory_order_relaxed);
  int b = 0;
  while (b < kLatBuckets && us > kLatBoundsUs[b]) b++;
  st.lat_buckets[b].fetch_add(1, std::memory_order_relaxed);
  if (us >= st.slow_us.load(std::memory_order_relaxed)) {
    std::lock_guard<std::mutex> g(st.slow_mu);
    SlowEntry& e = st.slow[st.slow_seq % kSlowRing];
    snprintf(e.method, sizeof e.method, "%s", req.method.c_str());
    snprintf(e.target, sizeof e.target, "%s", req.target.c_str());
    e.status = status;
    e.bytes = bytes;
    e.micros = us;
    e.unix_ms = wall_ms();
    st.slow_seq++;
  }
}

void send_deferred(Server* s, std::vector<DeferredAck> acks, bool ok) {
  for (auto& a : acks) {
    const std::string& out = ok ? a.resp : a.fallback;
    send_all(a.fd, out.data(), out.size());
    close(a.fd);
    a.fd = -1;
    if (s) {
      if (!ok) s->redirected++;
      if (a.t0_us) {  // stats were on when the request started
        Request rq;
        rq.method = "POST";
        rq.target = a.target;
        record_request(s, rq, ok ? 200 : 307, ok ? a.bytes : 0,
                       mono_us() - a.t0_us);
      }
    }
  }
  if (s && !acks.empty())
    s->fsync_pending.fetch_sub(acks.size(), std::memory_order_relaxed);
}

// Reads one request off the socket (blocking). Returns 1 ok, 0 clean EOF,
// -1 error/overflow.
int read_request(int fd, std::string* acc, Request* out) {
  // acc may already hold pipelined bytes from the previous read
  size_t scanned = 0;
  for (;;) {
    size_t pos = acc->find("\r\n\r\n", scanned > 3 ? scanned - 3 : 0);
    if (pos != std::string::npos) {
      std::string head = acc->substr(0, pos);
      acc->erase(0, pos + 4);
      // request line
      size_t sp1 = head.find(' ');
      size_t sp2 = head.find(' ', sp1 + 1);
      size_t eol = head.find("\r\n");
      if (sp1 == std::string::npos || sp2 == std::string::npos ||
          sp2 > (eol == std::string::npos ? head.size() : eol))
        return -1;
      out->method = head.substr(0, sp1);
      out->target = head.substr(sp1 + 1, sp2 - sp1 - 1);
      out->http10 = head.compare(sp2 + 1, 8, "HTTP/1.0") == 0;
      out->keepalive = !out->http10;
      // headers we care about
      size_t ls = (eol == std::string::npos) ? head.size() : eol + 2;
      while (ls < head.size()) {
        size_t le = head.find("\r\n", ls);
        if (le == std::string::npos) le = head.size();
        size_t colon = head.find(':', ls);
        if (colon != std::string::npos && colon < le) {
          std::string k = head.substr(ls, colon - ls);
          size_t vs = colon + 1;
          while (vs < le && head[vs] == ' ') vs++;
          std::string v = head.substr(vs, le - vs);
          for (auto& c : k)
            c = static_cast<char>(tolower(static_cast<unsigned char>(c)));
          if (k == "connection") {
            std::string lv = v;
            for (auto& c : lv)
              c = static_cast<char>(tolower(static_cast<unsigned char>(c)));
            if (lv.find("close") != std::string::npos) out->keepalive = false;
            if (out->http10 && lv.find("keep-alive") != std::string::npos)
              out->keepalive = true;
          } else if (k == "if-none-match") {
            out->if_none_match = v;
          } else if (k == "if-modified-since") {
            out->if_modified_since = v;
          } else if (k == "range") {
            out->range = v;
          } else if (k == "content-type") {
            out->content_type = v;
          } else if (k == "content-length") {
            // trim trailing whitespace, then demand a clean all-DIGIT
            // parse (RFC 9110): strtoll alone would accept "+10" or
            // "\t10", whose framing an intermediary may read
            // differently — treat those as unreadable and sever
            while (!v.empty() && (v.back() == ' ' || v.back() == '\t'))
              v.pop_back();
            char* end = nullptr;
            out->content_length =
                (!v.empty() && isdigit(static_cast<unsigned char>(v[0])))
                    ? strtoll(v.c_str(), &end, 10)
                    : -1;
            if (v.empty() || out->content_length < 0 ||
                (end && *end != '\0')) {
              out->content_length = 0;
              out->keepalive = false;
            }
          } else if (k == "transfer-encoding") {
            out->chunked = true;  // no body framing here: close after
          } else if (k.compare(0, 8, "seaweed-") == 0) {
            out->has_pair_headers = true;
          }
        }
        ls = le + 2;
      }
      return 1;
    }
    if (acc->size() > 16384) return -1;  // header cap
    scanned = acc->size();
    char buf[4096];
    ssize_t r = recv(fd, buf, sizeof buf, 0);
    if (r == 0) return acc->empty() ? 0 : -1;
    if (r < 0) return -1;
    acc->append(buf, static_cast<size_t>(r));
  }
}

std::string format_head(int code, const char* reason, size_t body_len,
                        bool keepalive,
                        const std::string& extra_headers,
                        const char* ctype) {
  return "HTTP/1.1 " + std::to_string(code) + " " + reason +
         "\r\nContent-Length: " + std::to_string(body_len) +
         "\r\nContent-Type: " + ctype + "\r\n" + extra_headers +
         "Connection: " + (keepalive ? "keep-alive" : "close") +
         "\r\n\r\n";
}

// full response bytes in one buffer, for acks sent later by a thread
// that isn't the connection's own (group-commit deferred acks)
std::string format_response(int code, const char* reason,
                            const std::string& body, bool keepalive,
                            const std::string& extra_headers = "",
                            const char* ctype = "text/plain") {
  std::string out =
      format_head(code, reason, body.size(), keepalive, extra_headers,
                  ctype);
  out += body;
  return out;
}

void respond_simple(int fd, int code, const char* reason,
                    const std::string& body, bool keepalive,
                    const std::string& extra_headers = "",
                    const char* ctype = "text/plain") {
  tl_status = code;
  tl_bytes += body.size();
  std::string head = format_head(code, reason, body.size(), keepalive,
                                 extra_headers, ctype);
  if (body.empty())
    send_all(fd, head.data(), head.size());
  else
    send_two(fd, head.data(), head.size(), body.data(), body.size());
}

void redirect_to_fallback(Server* s, int fd, const Request& req) {
  s->redirected++;
  std::string loc = "http://" + s->fallback + req.target;
  std::string hdr = "Location: " + loc + "\r\n";
  // 307 preserves method+body; our fallback is the authoritative server
  respond_simple(fd, 307, "Temporary Redirect", "", req.keepalive, hdr);
}

// `%xx` unescape for the path (fids are plain hex, but be tolerant)
std::string unescape(const std::string& in) {
  std::string out;
  out.reserve(in.size());
  for (size_t i = 0; i < in.size(); i++) {
    if (in[i] == '%' && i + 2 < in.size() &&
        isxdigit(static_cast<unsigned char>(in[i + 1])) &&
        isxdigit(static_cast<unsigned char>(in[i + 2]))) {
      out.push_back(static_cast<char>(
          strtol(in.substr(i + 1, 2).c_str(), nullptr, 16)));
      i += 2;
    } else {
      out.push_back(in[i]);
    }
  }
  return out;
}

bool all_digits(const std::string& s) {
  if (s.empty()) return false;
  for (char c : s)
    if (!isdigit(static_cast<unsigned char>(c))) return false;
  return true;
}

// Parse "/<vid>,<keyhex><cookie8>[_<n>]" (also '/' separator). The _n
// suffix is the batch-assign convention (reference common.go parses
// "fid_i" as key+i for ?count= assigns; storage/types.py mirrors it).
// Returns false if the target is not a plain fid path (query string,
// extension, etc).
bool parse_fid_path(const std::string& target, uint32_t* vid, uint64_t* key,
                    uint32_t* cookie) {
  if (target.empty() || target[0] != '/') return false;
  if (target.find('?') != std::string::npos) return false;
  std::string p = unescape(target.substr(1));
  size_t sep = p.find(',');
  if (sep == std::string::npos) sep = p.find('/');
  if (sep == std::string::npos || sep == 0) return false;
  uint64_t v = 0;
  for (size_t i = 0; i < sep; i++) {
    if (!isdigit(static_cast<unsigned char>(p[i]))) return false;
    v = v * 10 + static_cast<uint64_t>(p[i] - '0');
    if (v > 0xFFFFFFFFull) return false;
  }
  std::string kh = p.substr(sep + 1);
  uint64_t delta = 0;
  size_t us = kh.find('_');
  if (us != std::string::npos) {
    std::string d = kh.substr(us + 1);
    if (!all_digits(d) || d.size() > 18) return false;
    delta = strtoull(d.c_str(), nullptr, 10);
    kh = kh.substr(0, us);
  }
  // mirror storage/types.py parse_key_hash: 8 < len <= 24, last 8 hex
  // chars are the cookie
  if (kh.size() <= 8 || kh.size() > 24) return false;
  for (char c : kh)
    if (!isxdigit(static_cast<unsigned char>(c))) return false;
  if (kh.size() % 2) kh = "0" + kh;
  uint64_t k = 0;
  for (size_t i = 0; i + 8 < kh.size(); i++)
    k = k << 4 | static_cast<uint64_t>(strtol(kh.substr(i, 1).c_str(),
                                              nullptr, 16));
  uint32_t ck = static_cast<uint32_t>(
      strtoul(kh.substr(kh.size() - 8).c_str(), nullptr, 16));
  *vid = static_cast<uint32_t>(v);
  *key = k + delta;
  *cookie = ck;
  return true;
}

// Single-range parse: "bytes=a-b" / "bytes=a-" / "bytes=-n" (mirrors
// server/http_util.parse_range; multi-range -> not handled -> full body)
bool parse_range_header(const std::string& r, int64_t total, int64_t* start,
                        int64_t* length) {
  if (r.compare(0, 6, "bytes=") != 0) return false;
  std::string spec = r.substr(6);
  if (spec.find(',') != std::string::npos) return false;
  size_t dash = spec.find('-');
  if (dash == std::string::npos) return false;
  std::string a = spec.substr(0, dash), b = spec.substr(dash + 1);
  if (a.empty() && b.empty()) return false;
  if ((!a.empty() && !all_digits(a)) || (!b.empty() && !all_digits(b)))
    return false;  // malformed bounds -> not parseable (Python: 416)
  if (a.empty()) {  // suffix: last n bytes
    int64_t n = strtoll(b.c_str(), nullptr, 10);
    if (n <= 0) return false;
    if (n > total) n = total;
    *start = total - n;
    *length = n;
    return true;
  }
  int64_t s = strtoll(a.c_str(), nullptr, 10);
  if (s >= total) return false;
  int64_t e = b.empty() ? total - 1 : strtoll(b.c_str(), nullptr, 10);
  if (e >= total) e = total - 1;
  if (e < s) return false;
  *start = s;
  *length = e - s + 1;
  return true;
}

void quote_escape(const std::string& in, std::string* out) {
  for (char c : in) {
    if (c == '\\' || c == '"') out->push_back('\\');
    out->push_back(c);
  }
}

// Shared response tail for the plain and EC fast paths: parse + validate
// the raw needle record and emit the HTTP response. Returns false when
// the request must be redirected to Python instead (semantics beyond the
// fast path; in `lenient` mode also any corruption/crc failure — the EC
// path assembles bytes from cached reconstructions, so Python, not a
// 500, stays authoritative when they don't check out). `also`, when
// non-null, is bumped alongside `served` before every send so EC
// outcome counters keep the same observer guarantee.
bool respond_needle_blob(Server* s, int fd, const Request& req,
                         uint32_t cookie, const uint8_t* blob, size_t blen,
                         int version, uint32_t size, bool lenient,
                         std::atomic<uint64_t>* also) {
  ParsedNeedle n;
  if (parse_needle(blob, blen, version, &n) != 0 || n.size != size) {
    if (lenient) return false;
    s->errors++;
    respond_simple(fd, 500, "Internal Server Error", "corrupt needle",
                   req.keepalive);
    return true;
  }
  if (n.cookie != cookie) {
    respond_simple(fd, 404, "Not Found", "cookie mismatch", req.keepalive);
    return true;
  }
  if (size > 0 && masked_crc(crc32c(n.data, n.data_size)) != n.checksum) {
    if (lenient) return false;
    s->errors++;
    respond_simple(fd, 500, "Internal Server Error", "crc mismatch",
                   req.keepalive);
    return true;
  }
  // TTL expiry (volume.read_needle)
  if ((n.flags & kFlagHasTtl) && (n.flags & kFlagHasLastModified)) {
    int64_t mins = ttl_minutes(n.ttl_count, n.ttl_unit);
    if (mins > 0 &&
        time(nullptr) - n.last_modified > mins * 60) {
      respond_simple(fd, 404, "Not Found", "needle expired", req.keepalive);
      return true;
    }
  }
  // semantics beyond the fast path live in Python
  if (n.flags & (kFlagGzip | kFlagChunkManifest | kFlagHasPairs))
    return false;
  char etag[16];
  snprintf(etag, sizeof etag, "%02x%02x%02x%02x", n.checksum >> 24 & 0xFF,
           n.checksum >> 16 & 0xFF, n.checksum >> 8 & 0xFF,
           n.checksum & 0xFF);
  // Last-Modified + If-Modified-Since, checked before the etag
  // (reference volume_server_handlers_read.go:99-109)
  std::string lm_header;
  if ((n.flags & kFlagHasLastModified) && n.last_modified > 0) {
    char buf[64];
    time_t t = static_cast<time_t>(n.last_modified);
    struct tm tmv;
    gmtime_r(&t, &tmv);
    strftime(buf, sizeof buf, "%a, %d %b %Y %H:%M:%S GMT", &tmv);
    lm_header = buf;
    if (!req.if_modified_since.empty()) {
      struct tm ims{};
      if (strptime(req.if_modified_since.c_str(),
                   "%a, %d %b %Y %H:%M:%S GMT", &ims) != nullptr) {
        if (timegm(&ims) >= n.last_modified) {
          std::string hdr = "Last-Modified: " + lm_header +
                            "\r\nEtag: \"" + etag + "\"\r\n";
          // counters bump BEFORE the response bytes leave: an observer
          // that has received the response must see the count (a
          // post-send bump races clients on a loaded single-core host)
          s->served++;
          if (also) (*also)++;
          respond_simple(fd, 304, "Not Modified", "", req.keepalive, hdr,
                         "application/octet-stream");
          return true;
        }
      }
    }
  }
  // conditional GET (RFC7232 comma list, weak validators, "*")
  if (!req.if_none_match.empty()) {
    std::string quoted = std::string("\"") + etag + "\"";
    std::string inm = req.if_none_match;
    bool match = false;
    size_t pos = 0;
    while (pos <= inm.size()) {
      size_t comma = inm.find(',', pos);
      std::string c = inm.substr(
          pos, comma == std::string::npos ? std::string::npos : comma - pos);
      // trim + strip weak prefix
      size_t b = c.find_first_not_of(" \t");
      size_t e = c.find_last_not_of(" \t");
      if (b != std::string::npos) {
        c = c.substr(b, e - b + 1);
        if (c.compare(0, 2, "W/") == 0) c = c.substr(2);
        if (c == "*" || c == quoted) {
          match = true;
          break;
        }
      }
      if (comma == std::string::npos) break;
      pos = comma + 1;
    }
    if (match) {
      // header set mirrors the Python 304 (Etag + default octet-stream)
      std::string hdr = "Etag: " + quoted + "\r\n";
      s->served++;  // before the send — see the IMS 304 comment
      if (also) (*also)++;
      respond_simple(fd, 304, "Not Modified", "", req.keepalive, hdr,
                     "application/octet-stream");
      return true;
    }
  }
  const char* ctype = "application/octet-stream";
  std::string mime_hold;
  if ((n.flags & kFlagHasMime) && !n.mime.empty()) {
    mime_hold = n.mime;
    ctype = mime_hold.c_str();
  }
  // image resize queries never reach here (any '?' redirects), so a
  // plain GET of an image serves stored bytes — same as Python with no
  // width/height args.
  const uint8_t* body = n.data;
  int64_t total = n.data_size;
  int64_t start = 0, length = total;
  bool ranged = false;
  if (!req.range.empty()) {
    if (parse_range_header(req.range, total, &start, &length)) {
      ranged = true;
    } else if (req.range.compare(0, 6, "bytes=") == 0) {
      // unsatisfiable/multi range: Python answers 416 for bad single
      // ranges; multi-ranges fall through to full body there. Redirect
      // so every edge keeps one source of truth.
      return false;
    }
  }
  std::string head;
  head.reserve(512);
  head += ranged ? "HTTP/1.1 206 Partial Content\r\n" : "HTTP/1.1 200 OK\r\n";
  head += "Content-Length: " + std::to_string(length) + "\r\n";
  head += "Content-Type: ";
  head += ctype;
  head += "\r\nEtag: \"";
  head += etag;
  head += "\"\r\nAccept-Ranges: bytes\r\n";
  if (!lm_header.empty())
    head += "Last-Modified: " + lm_header + "\r\n";
  if (n.flags & kFlagHasName) {
    std::string esc;
    quote_escape(n.name, &esc);
    head += "Content-Disposition: inline; filename=\"" + esc + "\"\r\n";
  }
  if (ranged)
    head += "Content-Range: bytes " + std::to_string(start) + "-" +
            std::to_string(start + length - 1) + "/" +
            std::to_string(total) + "\r\n";
  head += req.keepalive ? "Connection: keep-alive\r\n\r\n"
                        : "Connection: close\r\n\r\n";
  s->served++;  // before the send — see the IMS 304 comment
  if (also) (*also)++;
  tl_status = ranged ? 206 : 200;
  if (req.method == "HEAD") {
    send_all(fd, head.data(), head.size());
  } else {
    tl_bytes += static_cast<uint64_t>(length);
    send_two(fd, head.data(), head.size(), body + start,
             static_cast<size_t>(length));
  }
  return true;
}

// Copies [shard_off, shard_off+take) of a LOST shard's byte stream out of
// the slab cache into dst. Every covering slab must be resident; a slab
// shorter than the logical slab size (shard tail) leaves dst's zero-fill
// in place, mirroring the Python engine's zero-padding. Hit/miss counts
// are per-slab-lookup and exact (under the cache mutex).
bool copy_from_cache(Server* s, uint32_t vid, int sid, int64_t slab,
                     int64_t shard_off, int64_t take, uint8_t* dst) {
  if (slab <= 0) return false;
  uint64_t vs = static_cast<uint64_t>(vid) << 32 |
                static_cast<uint32_t>(sid);
  int64_t lo = shard_off, hi = shard_off + take;
  for (int64_t idx = lo / slab; idx * slab < hi; idx++) {
    std::shared_ptr<std::vector<uint8_t>> data;
    {
      std::lock_guard<std::mutex> g(s->cache.mu);
      auto it = s->cache.map.find(
          SlabKey{vs, static_cast<uint64_t>(idx)});
      if (it == s->cache.map.end()) {
        s->cache.misses++;
        return false;
      }
      s->cache.hits++;
      s->cache.lru.splice(s->cache.lru.begin(), s->cache.lru, it->second);
      data = it->second->second;
    }
    int64_t s_lo = std::max(lo, idx * slab);
    int64_t s_hi = std::min(hi, (idx + 1) * slab);
    int64_t in_lo = s_lo - idx * slab;
    int64_t in_hi = s_hi - idx * slab;
    int64_t avail = std::min<int64_t>(
        in_hi, static_cast<int64_t>(data->size()));
    if (avail > in_lo)
      memcpy(dst + (s_lo - lo), data->data() + in_lo,
             static_cast<size_t>(avail - in_lo));
  }
  return true;
}

// In-plane EC needle GET. Walks the needle's logical .dat range through
// the striping math (exact mirror of ec/locate.py: encoder-derived large
// row count, row-major block walk, large->small rollover), reading local
// shards via pread and lost shards from the slab cache. Any gap — index
// miss, unregistered shard with no resident slabs, oversize, validation
// failure — redirects to Python exactly as before this path existed.
// Adds NO clock reads: timing stays in handle_conn behind the stats
// gate.
void serve_ec_needle(Server* s, int fd, const Request& req,
                     const std::shared_ptr<EcVolumeRec>& ev, uint32_t vid,
                     uint64_t key, uint32_t cookie) {
  uint64_t offset;
  uint32_t size;
  {
    std::shared_lock<std::shared_mutex> l(ev->mu);
    auto it = ev->index.find(key);
    if (it == ev->index.end() || it->second.second == kTombstoneSize) {
      // mirror semantics match the plain path: Python's .ecx is
      // authoritative for misses/tombstones (404 vs re-sync window)
      l.unlock();
      s->stats.index_misses.fetch_add(1, std::memory_order_relaxed);
      redirect_to_fallback(s, fd, req);
      return;
    }
    offset = it->second.first;
    size = it->second.second;
  }
  int64_t want = actual_size(size, ev->version);
  if (want > s->max_fastpath_bytes ||
      static_cast<int64_t>(offset) + want > ev->dat_size) {
    redirect_to_fallback(s, fd, req);
    return;
  }
  std::vector<uint8_t> blob(static_cast<size_t>(want), 0);
  int64_t large_row = ev->large_block * kDataShards;
  int64_t n_large = ec_n_large_rows(ev->dat_size, ev->large_block);
  int64_t block_index, inner;
  bool is_large;
  if (static_cast<int64_t>(offset) < n_large * large_row) {
    block_index = static_cast<int64_t>(offset) / ev->large_block;
    is_large = true;
    inner = static_cast<int64_t>(offset) % ev->large_block;
  } else {
    int64_t off2 = static_cast<int64_t>(offset) - n_large * large_row;
    block_index = off2 / ev->small_block;
    is_large = false;
    inner = off2 % ev->small_block;
  }
  bool used_cache = false;
  bool cache_gap = false;  // lost shard whose slabs weren't resident
  bool ok = true;
  int64_t pos = 0, remaining = want;
  {
    // shared lock across the assembly: swhp_ec_set_shard swaps fds under
    // the unique lock, so no pread can race a close
    std::shared_lock<std::shared_mutex> l(ev->mu);
    while (remaining > 0) {
      int64_t blk = is_large ? ev->large_block : ev->small_block;
      int64_t take = std::min(remaining, blk - inner);
      int sid = static_cast<int>(block_index % kDataShards);
      int64_t row = block_index / kDataShards;
      int64_t shard_off =
          inner + (is_large ? row * ev->large_block
                            : n_large * ev->large_block +
                                  row * ev->small_block);
      int sfd = ev->shard_fds[sid];
      if (sfd >= 0) {
        // a short read past the shard tail leaves the zero-fill, same
        // as the engine's zero-padded slab pieces
        if (pread(sfd, blob.data() + pos, static_cast<size_t>(take),
                  static_cast<off_t>(shard_off)) < 0) {
          ok = false;
          break;
        }
      } else {
        if (!copy_from_cache(s, vid, sid, ev->slab_bytes, shard_off, take,
                             blob.data() + pos)) {
          ok = false;
          cache_gap = true;
          break;
        }
        used_cache = true;
      }
      pos += take;
      remaining -= take;
      if (remaining <= 0) break;
      block_index++;
      if (is_large && block_index == n_large * kDataShards) {
        is_large = false;
        block_index = 0;
      }
      inner = 0;
    }
  }
  if (!ok) {
    if (cache_gap)
      s->ec_degraded_redirected.fetch_add(1, std::memory_order_relaxed);
    redirect_to_fallback(s, fd, req);
    return;
  }
  std::atomic<uint64_t>* outcome =
      used_cache ? &s->ec_degraded_served : &s->ec_local_served;
  if (!respond_needle_blob(s, fd, req, cookie, blob.data(), blob.size(),
                           ev->version, size, /*lenient=*/true, outcome)) {
    if (used_cache)
      s->ec_degraded_redirected.fetch_add(1, std::memory_order_relaxed);
    redirect_to_fallback(s, fd, req);
  }
}

void serve_needle(Server* s, int fd, const Request& req, uint32_t vid,
                  uint64_t key, uint32_t cookie) {
  auto vol = s->find(vid);
  if (!vol) {
    auto ev = s->find_ec(vid);
    if (ev) {
      serve_ec_needle(s, fd, req, ev, vid, key, cookie);
      return;
    }
    redirect_to_fallback(s, fd, req);  // remote / replica logic
    return;
  }
  uint64_t offset;
  uint32_t size;
  {
    std::shared_lock<std::shared_mutex> l(vol->mu);
    auto it = vol->index.find(key);
    if (it == vol->index.end() || it->second.first == 0 ||
        it->second.second == kTombstoneSize) {
      // The index here is only a MIRROR: during a re-sync window
      // (compaction commit, volume copy, tail receive) or after a
      // put/delete reorder it can transiently miss live needles. A
      // miss therefore redirects to the authoritative Python server —
      // a true miss still ends as its 404, a windowed miss is served.
      l.unlock();
      s->stats.index_misses.fetch_add(1, std::memory_order_relaxed);
      redirect_to_fallback(s, fd, req);
      return;
    }
    offset = it->second.first;
    size = it->second.second;
  }
  int64_t want = actual_size(size, vol->version);
  if (want > s->max_fastpath_bytes) {  // huge blob: let Python stream it
    redirect_to_fallback(s, fd, req);
    return;
  }
  std::vector<uint8_t> blob(static_cast<size_t>(want));
  ssize_t got = pread(vol->fd, blob.data(), blob.size(),
                      static_cast<off_t>(offset));
  if (got < want) {
    s->errors++;
    respond_simple(fd, 500, "Internal Server Error", "short read",
                   req.keepalive);
    return;
  }
  if (!respond_needle_blob(s, fd, req, cookie, blob.data(), blob.size(),
                           vol->version, size, /*lenient=*/false,
                           nullptr))
    redirect_to_fallback(s, fd, req);
}

// ----------------------------------------------------------------- write
bool pwrite_all(int fd, const uint8_t* buf, size_t n, int64_t off) {
  while (n > 0) {
    ssize_t w = pwrite(fd, buf, n, static_cast<off_t>(off));
    if (w <= 0) {
      if (w < 0 && errno == EINTR) continue;
      return false;
    }
    buf += w;
    off += w;
    n -= static_cast<size_t>(w);
  }
  return true;
}

bool write_all_fd(int fd, const uint8_t* buf, size_t n) {
  while (n > 0) {
    ssize_t w = write(fd, buf, n);
    if (w <= 0) {
      if (w < 0 && errno == EINTR) continue;
      return false;
    }
    buf += w;
    n -= static_cast<size_t>(w);
  }
  return true;
}

void be32_store(uint8_t* p, uint32_t v) {
  p[0] = static_cast<uint8_t>(v >> 24);
  p[1] = static_cast<uint8_t>(v >> 16);
  p[2] = static_cast<uint8_t>(v >> 8);
  p[3] = static_cast<uint8_t>(v);
}

void be64_store(uint8_t* p, uint64_t v) {
  for (int i = 0; i < 8; i++)
    p[i] = static_cast<uint8_t>(v >> (8 * (7 - i)));
}

// The append core: .dat record + .idx entry + mirror + counter deltas.
// Caller holds w->mu (do_append below — the only caller — takes it).
// size_field==kTombstoneSize marks a delete (blob is the tombstone
// record; the .idx entry gets offset 0 + tombstone size, mirroring
// NeedleMap.delete).
// check_cookie: re-verify the overwrite/delete cookie against the
// STORED needle under the mutex — the caller's pre-check raced with
// other appends (Python's write_needle holds volume.lock across
// check+append; the mutex is this plane's equivalent).
// Returns the append offset, or -1 writer gone, -2 addressing ceiling,
// -3 I/O error (tails truncated back; an untruncatable torn .idx
// fail-stops the writer rather than misalign every later record),
// -4 cookie mismatch.
int64_t do_append_locked(VolumeRec* vol, Writer* w, const uint8_t* blob,
                         int64_t len, uint64_t key, uint32_t size_field,
                         bool check_cookie, uint32_t cookie,
                         int64_t* freed_out) {
  if (w->fd < 0) return -1;
  int64_t tail = w->tail.load(std::memory_order_relaxed);
  if (tail + len > w->max_size) return -2;
  if (check_cookie) {
    uint64_t old_off = 0;
    bool have_old = false;
    {
      std::shared_lock<std::shared_mutex> l(vol->mu);
      auto it = vol->index.find(key);
      if (it != vol->index.end() && it->second.first != 0 &&
          it->second.second != kTombstoneSize) {
        old_off = it->second.first;
        have_old = true;
      }
    }
    if (have_old) {
      uint8_t hdr[4];
      if (pread(vol->fd, hdr, 4, static_cast<off_t>(old_off)) == 4 &&
          be32(hdr) != cookie)
        return -4;
    }
  }
  if (!pwrite_all(w->fd, blob, static_cast<size_t>(len), tail)) {
    int e1 = ftruncate(w->fd, static_cast<off_t>(tail));
    (void)e1;
    return -3;
  }
  uint8_t e[17];
  int ew = 8 + w->offset_width + 4;
  be64_store(e, key);
  uint64_t stored = size_field == kTombstoneSize
                        ? 0
                        : static_cast<uint64_t>(tail) / 8;
  for (int i = 0; i < w->offset_width; i++)
    e[8 + i] = static_cast<uint8_t>(stored >> (8 * (w->offset_width - 1 - i)));
  be32_store(e + 8 + w->offset_width, size_field);
  if (!write_all_fd(w->idx_fd, e, static_cast<size_t>(ew))) {
    // a PARTIAL idx entry would misalign every later record: truncate
    // it back; if even that fails, fail-stop this writer (Python's
    // next lease cycle resumes from the consistent prefix)
    int e2 = ftruncate(w->fd, static_cast<off_t>(tail));
    (void)e2;
    if (ftruncate(w->idx_fd, static_cast<off_t>(w->idx_tail)) != 0) {
      w->accept_posts.store(false, std::memory_order_release);
      close(w->fd);
      close(w->idx_fd);
      w->fd = w->idx_fd = -1;
    }
    return -3;
  }
  w->idx_tail += ew;
  int64_t off = tail;
  w->tail.store(tail + len, std::memory_order_relaxed);
  {
    std::unique_lock<std::shared_mutex> l(vol->mu);
    auto it = vol->index.find(key);
    bool had = it != vol->index.end();
    uint32_t old_size = had ? it->second.second : 0;
    if (size_field == kTombstoneSize) {
      if (had) {
        vol->index.erase(it);
        w->deletes++;
        w->deleted_bytes += old_size;
        if (freed_out) *freed_out = old_size;
      }
    } else {
      vol->index[key] = {static_cast<uint64_t>(off), size_field};
      w->puts++;
      w->put_bytes += size_field;
      if (had) {  // overwrite: old record becomes garbage
        w->deletes++;
        w->deleted_bytes += old_size;
      }
    }
    uint64_t mk = w->max_key.load(std::memory_order_relaxed);
    while (key > mk &&
           !w->max_key.compare_exchange_weak(mk, key)) {
    }
  }
  return off;
}

// Append + durability, per the writer's frozen sync mode. Off: ack
// straight from the page cache (pre-durability behavior). Always: one
// inline fdatasync pair per append under the mutex — the measured
// baseline group mode is judged against. Group: publish a sequence
// number to the committer, RELEASE the append mutex (later appends must
// batch up behind this one, not serialize on its fsync), and wait until
// one fdatasync covers the sequence. Adds -5 to the error codes above:
// durability was lost before the ack (fsync error poisoned the batch,
// or the lease was torn down mid-batch) — the record may or may not be
// on disk, so the caller must NOT ack; Python stays authoritative and a
// client retry lands as a harmless duplicate whose index entry wins.
// do_append also accepts a prepared DeferredAck (`defer`): in group
// mode the rider then doesn't block on the commit at all — its ack is
// queued with the committer (consuming `defer`) and kAckDeferred is
// returned so the caller sends nothing. Blocking-rider and always-mode
// semantics are unchanged when defer is null or unarmed (fd < 0).
constexpr int64_t kAckDeferred = -6;

int64_t do_append(VolumeRec* vol, Writer* w, const uint8_t* blob,
                  int64_t len, uint64_t key, uint32_t size_field,
                  bool check_cookie, uint32_t cookie,
                  int64_t* freed_out = nullptr,
                  DeferredAck* defer = nullptr) {
  uint64_t my_seq = 0;
  uint64_t my_gen = 0;
  bool group_wait = false;
  bool ack_deferred = false;
  int64_t off;
  {
    std::lock_guard<std::mutex> g(w->mu);
    off = do_append_locked(vol, w, blob, len, key, size_field,
                           check_cookie, cookie, freed_out);
    if (off >= 0 && w->sync_mode == 2) {
      bool timed = w->srv && w->srv->stats.enabled.load(
                                 std::memory_order_relaxed);
      uint64_t t0 = timed ? mono_us() : 0;
      if (fdatasync(w->fd) != 0 || fdatasync(w->idx_fd) != 0) {
        // inline fail-stop (poison_writer would re-lock w->mu)
        if (w->srv)
          w->srv->fsync_failures.fetch_add(1, std::memory_order_relaxed);
        {
          std::lock_guard<std::mutex> sg(w->sync_mu);
          w->sync_failed = true;
        }
        w->accept_posts.store(false, std::memory_order_release);
        close(w->fd);
        close(w->idx_fd);
        w->fd = w->idx_fd = -1;
        return -5;
      }
      if (w->srv)
        record_fsync(w->srv, 1, timed ? mono_us() - t0 : 0, timed);
    } else if (off >= 0 && w->sync_mode == 1) {
      std::lock_guard<std::mutex> sg(w->sync_mu);
      if (w->committer_stop || w->sync_failed) return -5;
      my_seq = ++w->append_seq;
      my_gen = w->sync_gen;  // the commit that will cover my_seq
      if (w->srv)
        w->srv->fsync_pending.fetch_add(1, std::memory_order_relaxed);
      if (defer && defer->fd >= 0) {
        defer->seq = my_seq;
        w->deferred.push_back(std::move(*defer));
        ack_deferred = true;
      } else {
        group_wait = true;
      }
      w->sync_cv.notify_one();
    }
  }
  if (ack_deferred) return kAckDeferred;
  if (group_wait) {
    std::unique_lock<std::mutex> sl(w->sync_mu);
    w->ack_cv[my_gen & 1].wait(sl, [&] {
      return w->synced_seq >= my_seq || w->sync_failed;
    });
    if (w->srv)
      w->srv->fsync_pending.fetch_sub(1, std::memory_order_relaxed);
    if (w->synced_seq < my_seq) return -5;
  }
  return off;
}

// First file part of a multipart/form-data body, mirroring
// http_util.Request.multipart_file: boundary split, one CRLF stripped
// per side, filename= part wins. Returns false when no file part.
bool parse_multipart(const std::string& ctype, const std::string& body,
                     std::string* filename, std::string* part_ctype,
                     const char** data, size_t* data_len) {
  if (ctype.compare(0, 19, "multipart/form-data") != 0) return false;
  size_t bpos = ctype.find("boundary=");
  if (bpos == std::string::npos) return false;
  std::string boundary = ctype.substr(bpos + 9);
  size_t send = boundary.find(';');
  if (send != std::string::npos) boundary = boundary.substr(0, send);
  if (!boundary.empty() && boundary.front() == '"') {
    size_t endq = boundary.find('"', 1);
    if (endq == std::string::npos) return false;
    boundary = boundary.substr(1, endq - 1);
  }
  if (boundary.empty()) return false;
  std::string delim = "--" + boundary;
  size_t pos = 0;
  while (pos != std::string::npos && pos < body.size()) {
    size_t start = body.find(delim, pos);
    if (start == std::string::npos) break;
    start += delim.size();
    size_t stop = body.find(delim, start);
    size_t part_end = stop == std::string::npos ? body.size() : stop;
    pos = stop;
    // part is body[start, part_end); strip exactly one CRLF per side
    size_t b = start, e = part_end;
    if (e - b >= 2 && body.compare(b, 2, "\r\n") == 0) b += 2;
    if (e - b >= 2 && body.compare(e - 2, 2, "\r\n") == 0) e -= 2;
    if (e <= b) continue;
    size_t hdr_end = body.find("\r\n\r\n", b);
    if (hdr_end == std::string::npos || hdr_end + 4 > e) continue;
    std::string head = body.substr(b, hdr_end - b);
    std::string lower = head;
    for (auto& c : lower)
      c = static_cast<char>(tolower(static_cast<unsigned char>(c)));
    size_t fpos = lower.find("filename=\"");
    if (fpos == std::string::npos) continue;
    // filename value with \" and \\ unescaped (Python regex
    // filename="((?:[^"\\]|\\.)*)")
    std::string fn;
    size_t i = fpos + 10;
    bool closed = false;
    while (i < head.size()) {
      char c = head[i];
      if (c == '\\' && i + 1 < head.size()) {
        fn.push_back(head[i + 1]);
        i += 2;
        continue;
      }
      if (c == '"') {
        closed = true;
        break;
      }
      fn.push_back(c);
      i++;
    }
    if (!closed) continue;
    std::string pct;
    size_t cpos = lower.find("content-type:");
    if (cpos != std::string::npos) {
      size_t vs = cpos + 13;
      while (vs < head.size() && head[vs] == ' ') vs++;
      size_t ve = head.find("\r\n", vs);
      if (ve == std::string::npos || ve > hdr_end) ve = hdr_end;
      pct = head.substr(vs, ve - vs);
      while (!pct.empty() && (pct.back() == ' ' || pct.back() == '\r'))
        pct.pop_back();
    }
    *filename = fn;
    *part_ctype = pct;
    *data = body.data() + hdr_end + 4;
    *data_len = e - (hdr_end + 4);
    return true;
  }
  return false;
}

// Build a v2/v3 needle record the way storage/needle.py to_bytes does
// for the plain-upload shape: data + optional name/mime +
// last-modified(now). Returns the full padded record; *size_out gets
// the header Size field, *crc_out the masked checksum.
std::vector<uint8_t> build_needle(uint32_t cookie, uint64_t key,
                                  const uint8_t* data, size_t data_len,
                                  const std::string& name,
                                  const std::string& mime, int version,
                                  uint32_t* size_out, uint32_t* crc_out) {
  uint8_t flags = kFlagHasLastModified;  // Python always stamps mtime
  std::string nm = name.substr(0, 255);
  std::string mm = mime.substr(0, 255);
  if (!nm.empty()) flags |= kFlagHasName;
  if (!mm.empty()) flags |= kFlagHasMime;
  size_t body = 4 + data_len + 1;
  if (flags & kFlagHasName) body += 1 + nm.size();
  if (flags & kFlagHasMime) body += 1 + mm.size();
  body += 5;  // last-modified
  size_t base = kHeaderSize + body + kChecksumSize +
                (version == 3 ? kTimestampSize : 0);
  size_t pad = kPaddingSize - base % kPaddingSize;  // never 0
  std::vector<uint8_t> out(base + pad, 0);
  uint8_t* p = out.data();
  be32_store(p, cookie);
  be64_store(p + 4, key);
  be32_store(p + 12, static_cast<uint32_t>(body));
  p += kHeaderSize;
  be32_store(p, static_cast<uint32_t>(data_len));
  p += 4;
  memcpy(p, data, data_len);
  p += data_len;
  *p++ = flags;
  if (flags & kFlagHasName) {
    *p++ = static_cast<uint8_t>(nm.size());
    memcpy(p, nm.data(), nm.size());
    p += nm.size();
  }
  if (flags & kFlagHasMime) {
    *p++ = static_cast<uint8_t>(mm.size());
    memcpy(p, mm.data(), mm.size());
    p += mm.size();
  }
  int64_t now_s = time(nullptr);
  for (int i = 0; i < 5; i++)
    *p++ = static_cast<uint8_t>(now_s >> (8 * (4 - i)));
  uint32_t crc = masked_crc(crc32c(data, data_len));
  be32_store(p, crc);
  p += 4;
  if (version == 3) {
    struct timespec ts;
    clock_gettime(CLOCK_REALTIME, &ts);
    be64_store(p, static_cast<uint64_t>(ts.tv_sec) * 1000000000ull +
                      static_cast<uint64_t>(ts.tv_nsec));
  }
  *size_out = static_cast<uint32_t>(body);
  *crc_out = crc;
  return out;
}

// JSON string escape for the upload response's "name" (quotes,
// backslashes, control chars; non-ASCII redirects before we get here).
void json_escape(const std::string& in, std::string* out) {
  for (char c : in) {
    unsigned char u = static_cast<unsigned char>(c);
    if (c == '"' || c == '\\') {
      out->push_back('\\');
      out->push_back(c);
    } else if (u < 0x20) {
      char buf[8];
      snprintf(buf, sizeof buf, "\\u%04x", u);
      *out += buf;
    } else {
      out->push_back(c);
    }
  }
}

// Plain needle POST on the fast path. The body has already been read.
// Anything off the fast path redirects to Python (which delegates its
// append back through swhp_append — same mutex, same tail).
void serve_write(Server* s, int fd, const Request& req,
                 const std::string& body, uint32_t vid, uint64_t key,
                 uint32_t cookie, bool pipelined) {
  auto vol = s->find(vid);
  if (!vol) {
    redirect_to_fallback(s, fd, req);
    return;
  }
  auto w = vol->get_writer();
  if (!w || !w->accept_posts.load(std::memory_order_acquire) ||
      vol->version == 1 || req.has_pair_headers) {
    redirect_to_fallback(s, fd, req);
    return;
  }
  std::string filename, part_ctype;
  const char* data = nullptr;
  size_t data_len = 0;
  if (!parse_multipart(req.content_type, body, &filename, &part_ctype,
                       &data, &data_len)) {
    // raw-body uploads and exotic envelopes keep one source of truth
    redirect_to_fallback(s, fd, req);
    return;
  }
  // Python guesses a mime from the filename extension (mimetypes reads
  // /etc/mime.types) and escapes non-ASCII names into \uXXXX JSON —
  // both are Python-owned behaviors, so those shapes redirect.
  for (char c : filename) {
    unsigned char u = static_cast<unsigned char>(c);
    if (u < 0x20 || u > 0x7E) {
      redirect_to_fallback(s, fd, req);
      return;
    }
  }
  std::string mime = part_ctype;
  if (mime.empty() && filename.find('.') != std::string::npos) {
    redirect_to_fallback(s, fd, req);
    return;
  }
  if (mime == "application/octet-stream") mime.clear();  // not stored
  if (data_len == 0) {
    // zero-size records are tombstones on disk; Python rejects these
    // loudly (storage/volume.py _reject_empty) — match its 500
    respond_simple(fd, 500, "Internal Server Error",
                   "{\"error\": \"needle " + std::to_string(key) +
                       ": empty data \\u2014 zero-size records are "
                       "tombstones; store empty objects at the filer "
                       "layer (an entry with no chunks)\"}",
                   req.keepalive, "", "application/json");
    return;
  }
  if (w->file_size_limit > 0 &&
      static_cast<int64_t>(data_len) > w->file_size_limit) {
    respond_simple(fd, 413, "Payload Too Large",
                   "{\"error\": \"file over the size limit\"}",
                   req.keepalive, "", "application/json");
    return;
  }
  uint32_t size_field = 0, crc = 0;
  std::vector<uint8_t> blob = build_needle(
      cookie, key, reinterpret_cast<const uint8_t*>(data), data_len,
      filename, mime, vol->version, &size_field, &crc);
  // the success ack depends only on request-side facts, so in group
  // mode it is pre-built and handed to the committer: the rider never
  // blocks on the commit — the committer sends the ack the moment the
  // covering fdatasync returns. Pipelined clients (rare: bytes of the
  // NEXT request already buffered) keep the blocking path so responses
  // cannot reorder with inline-served requests on the same connection.
  char etag[16];
  snprintf(etag, sizeof etag, "%02x%02x%02x%02x", crc >> 24 & 0xFF,
           crc >> 16 & 0xFF, crc >> 8 & 0xFF, crc & 0xFF);
  std::string resp = "{\"name\": \"";
  json_escape(filename, &resp);
  resp += "\", \"size\": " + std::to_string(data_len) +
          ", \"eTag\": \"" + etag + "\"}";
  DeferredAck da;
  if (w->sync_mode == 1 && !pipelined) {
    da.fd = dup(fd);  // dup: the conn thread's close can't race us
    if (da.fd >= 0) {
      da.resp = format_response(200, "OK", resp, req.keepalive, "",
                                "application/json");
      da.fallback = format_response(
          307, "Temporary Redirect", "", req.keepalive,
          "Location: http://" + s->fallback + req.target + "\r\n");
      da.bytes = resp.size();
      da.t0_us = tl_t0;
      da.target = req.target;
    }
  }
  // overwrite-cookie verification happens INSIDE do_append, under the
  // writer mutex (storage/volume.py holds volume.lock across
  // check+append; reference volume_read_write.go reads the stored
  // header's cookie)
  int64_t off = do_append(vol.get(), w.get(), blob.data(),
                          static_cast<int64_t>(blob.size()), key,
                          size_field, /*check_cookie=*/true, cookie,
                          nullptr, &da);
  if (off == kAckDeferred) {
    s->written++;
    tl_deferred = true;
    return;
  }
  if (off == -4) {
    respond_simple(fd, 500, "Internal Server Error",
                   "{\"error\": \"needle " + std::to_string(key) +
                       ": mismatching cookie on overwrite\"}",
                   req.keepalive, "", "application/json");
    return;
  }
  if (off == -2 || off == -1 || off == -5) {
    // addressing ceiling, the lease revoked between the accept_posts
    // check and the append (vacuum/readonly toggle), or durability lost
    // mid-batch (-5: fsync poison / lease teardown — the record was NOT
    // acked, so the client's retry through Python is a harmless
    // duplicate): Python is the authority in every case
    redirect_to_fallback(s, fd, req);
    return;
  }
  if (off < 0) {
    s->errors++;
    respond_simple(fd, 500, "Internal Server Error",
                   "{\"error\": \"write failed\"}", req.keepalive, "",
                   "application/json");
    return;
  }
  s->written++;  // before the send — see the IMS 304 comment
  respond_simple(fd, 200, "OK", resp, req.keepalive, "",
                 "application/json");
}

// Plain needle DELETE on the fast path: tombstone append under the
// same write lease (storage/volume.py delete_needle; reference
// volume_server_handlers_write.go DeleteHandler). Chunk-manifest
// needles redirect — the cascade to chunk needles is Python's.
void serve_delete(Server* s, int fd, const Request& req, uint32_t vid,
                  uint64_t key, uint32_t cookie) {
  auto vol = s->find(vid);
  if (!vol) {
    redirect_to_fallback(s, fd, req);
    return;
  }
  auto w = vol->get_writer();
  if (!w || !w->accept_posts.load(std::memory_order_acquire) ||
      vol->version == 1) {
    redirect_to_fallback(s, fd, req);
    return;
  }
  uint64_t off = 0;
  uint32_t size = 0;
  {
    std::shared_lock<std::shared_mutex> l(vol->mu);
    auto it = vol->index.find(key);
    if (it != vol->index.end()) {
      off = it->second.first;
      size = it->second.second;
    }
  }
  if (off == 0 || size == kTombstoneSize) {
    // already gone: Python answers freed=0 (goal state, not an error)
    respond_simple(fd, 200, "OK", "{\"size\": 0}", req.keepalive, "",
                   "application/json");
    return;
  }
  if (size > 0) {
    // manifest probe via two tiny preads (volume.read_needle_flags)
    uint8_t ds_raw[4];
    if (pread(vol->fd, ds_raw, 4, static_cast<off_t>(off + 16)) == 4) {
      uint32_t ds = be32(ds_raw);
      uint8_t flags = 0;
      if (ds < size &&
          pread(vol->fd, &flags, 1,
                static_cast<off_t>(off + 16 + 4 + ds)) == 1 &&
          (flags & kFlagChunkManifest)) {
        redirect_to_fallback(s, fd, req);
        return;
      }
    }
  }
  // tombstone record: empty body, crc of empty data, now-stamped
  size_t len = vol->version == 3 ? 32 : 24;
  uint8_t blob[32] = {0};
  be32_store(blob, cookie);
  be64_store(blob + 4, key);
  be32_store(blob + 12, 0);
  be32_store(blob + 16, masked_crc(crc32c(nullptr, 0)));
  if (vol->version == 3) {
    struct timespec ts;
    clock_gettime(CLOCK_REALTIME, &ts);
    be64_store(blob + 20, static_cast<uint64_t>(ts.tv_sec) *
                              1000000000ull +
                          static_cast<uint64_t>(ts.tv_nsec));
  }
  int64_t freed = 0;
  int64_t rc = do_append(vol.get(), w.get(), blob,
                         static_cast<int64_t>(len), key, kTombstoneSize,
                         /*check_cookie=*/true, cookie, &freed);
  if (rc == -4) {
    respond_simple(fd, 500, "Internal Server Error",
                   "{\"error\": \"needle " + std::to_string(key) +
                       ": mismatching cookie on delete\"}",
                   req.keepalive, "", "application/json");
    return;
  }
  if (rc == -2 || rc == -1 || rc == -5) {
    redirect_to_fallback(s, fd, req);
    return;
  }
  if (rc < 0) {
    s->errors++;
    respond_simple(fd, 500, "Internal Server Error",
                   "{\"error\": \"delete failed\"}", req.keepalive, "",
                   "application/json");
    return;
  }
  s->written++;  // before the send — see the IMS 304 comment
  respond_simple(fd, 200, "OK",
                 "{\"size\": " + std::to_string(freed) + "}",
                 req.keepalive, "", "application/json");
}

void handle_conn(Server* s, int fd) {
  struct timeval tv = {30, 0};
  setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof tv);
  setsockopt(fd, SOL_SOCKET, SO_SNDTIMEO, &tv, sizeof tv);
  int one = 1;
  setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof one);
  std::string acc;
  while (!s->stop.load(std::memory_order_relaxed)) {
    Request req;
    int r = read_request(fd, &acc, &req);
    if (r <= 0) break;
    // time from request-parsed to response handed to the kernel; the
    // enabled check keeps the counters-off path clock-free
    bool stats_on = s->stats.enabled.load(std::memory_order_relaxed);
    uint64_t t0 = stats_on ? mono_us() : 0;
    tl_status = 0;
    tl_bytes = 0;
    tl_deferred = false;
    tl_t0 = t0;
    if (req.chunked) req.keepalive = false;  // body framing not parsed
    uint32_t vid = 0, cookie = 0;
    uint64_t key = 0;
    bool fid_ok = parse_fid_path(req.target, &vid, &key, &cookie);
    bool is_write = (req.method == "POST" || req.method == "PUT") &&
                    fid_ok && !req.chunked && req.content_length > 0 &&
                    req.content_length <= s->max_fastpath_bytes;
    if (is_write) {
      // cheap pre-check BEFORE buffering the body: a cluster whose
      // volumes hold no lease (JWT/replicated/TTL'd) must not pay
      // 64MB of buffering per redirect — those drain + 307 below
      auto vol = s->find(vid);
      auto w = vol ? vol->get_writer() : nullptr;
      if (!w || !w->accept_posts.load(std::memory_order_acquire))
        is_write = false;
    }
    if (is_write) {
      // buffer the full multipart body (bounded by max_fastpath_bytes;
      // anything bigger goes to Python via the else-branch drain)
      std::string body;
      body.reserve(static_cast<size_t>(req.content_length));
      int64_t from_acc = std::min<int64_t>(
          req.content_length, static_cast<int64_t>(acc.size()));
      body.append(acc, 0, static_cast<size_t>(from_acc));
      acc.erase(0, static_cast<size_t>(from_acc));
      bool short_read = false;
      char buf[16384];
      while (static_cast<int64_t>(body.size()) < req.content_length) {
        int64_t want = std::min<int64_t>(
            req.content_length - static_cast<int64_t>(body.size()),
            static_cast<int64_t>(sizeof buf));
        ssize_t got = recv(fd, buf, static_cast<size_t>(want), 0);
        if (got <= 0) {
          short_read = true;
          break;
        }
        body.append(buf, static_cast<size_t>(got));
      }
      if (short_read) break;  // torn upload: nothing was appended
      // leftover buffered bytes = the client pipelined the next
      // request; deferring this ack could then reorder responses
      serve_write(s, fd, req, body, vid, key, cookie, !acc.empty());
      if (stats_on && !tl_deferred)
        record_request(s, req, tl_status, tl_bytes, mono_us() - t0);
      if (!req.keepalive) break;
      continue;
    }
    // drain any request body so leftover bytes can't desync the next
    // keep-alive request (redirected POST/PUT carry Content-Length)
    if (req.content_length > 0) {
      int64_t remaining = req.content_length;
      int64_t from_acc =
          std::min<int64_t>(remaining, static_cast<int64_t>(acc.size()));
      acc.erase(0, static_cast<size_t>(from_acc));
      remaining -= from_acc;
      char sink[8192];
      while (remaining > 0) {
        ssize_t got2 = recv(fd, sink,
                            std::min<int64_t>(remaining,
                                              static_cast<int64_t>(
                                                  sizeof sink)),
                            0);
        if (got2 <= 0) {
          req.keepalive = false;
          break;
        }
        remaining -= got2;
      }
    }
    if (req.method == "GET" || req.method == "HEAD") {
      if (fid_ok) {
        serve_needle(s, fd, req, vid, key, cookie);
      } else {
        redirect_to_fallback(s, fd, req);
      }
    } else if (req.method == "DELETE" && fid_ok) {
      serve_delete(s, fd, req, vid, key, cookie);
    } else {
      redirect_to_fallback(s, fd, req);
    }
    if (stats_on)
      record_request(s, req, tl_status, tl_bytes, mono_us() - t0);
    if (!req.keepalive) break;
  }
  {
    std::lock_guard<std::mutex> g(s->conns_mu);
    s->conns.erase(fd);
    close(fd);
  }
  s->live--;
}

void accept_loop(Server* s) {
  for (;;) {
    int fd = accept(s->listen_fd, nullptr, nullptr);
    if (fd < 0) {
      if (s->stop.load()) return;
      usleep(10000);  // EMFILE/transient: don't busy-spin a core
      continue;
    }
    if (s->stop.load()) {
      close(fd);
      return;
    }
    if (s->live.load() >= s->max_conns) {
      // bounded send: a client that opens excess connections and never
      // reads must not wedge the single acceptor thread
      struct timeval tv = {2, 0};
      setsockopt(fd, SOL_SOCKET, SO_SNDTIMEO, &tv, sizeof tv);
      respond_simple(fd, 503, "Service Unavailable", "too many connections",
                     false);
      close(fd);
      continue;
    }
    s->live++;
    {
      std::lock_guard<std::mutex> g(s->conns_mu);
      s->conns.insert(fd);
    }
    std::thread(handle_conn, s, fd).detach();
  }
}

}  // namespace

extern "C" {

// Returns an opaque handle (nullptr on failure). `fallback` is the
// host:port of the owning Python volume server (redirect target).
void* swhp_start(const char* host, uint16_t port, const char* fallback,
                 int max_conns) {
  auto s = std::make_unique<Server>();
  s->fallback = fallback ? fallback : "";
  if (max_conns > 0) s->max_conns = max_conns;
  int fd = socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) return nullptr;
  int one = 1;
  setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof one);
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons(port);
  addr.sin_addr.s_addr =
      host && *host ? inet_addr(host) : htonl(INADDR_LOOPBACK);
  if (addr.sin_addr.s_addr == INADDR_NONE ||
      bind(fd, reinterpret_cast<sockaddr*>(&addr), sizeof addr) != 0 ||
      listen(fd, 256) != 0) {
    close(fd);
    return nullptr;
  }
  socklen_t alen = sizeof addr;
  getsockname(fd, reinterpret_cast<sockaddr*>(&addr), &alen);
  s->port = ntohs(addr.sin_port);
  s->listen_fd = fd;
  Server* raw = s.release();
  raw->acceptor = std::thread(accept_loop, raw);
  return raw;
}

uint16_t swhp_port(void* h) { return static_cast<Server*>(h)->port; }

// Registers (or re-registers, e.g. after compaction) a volume. Opens its
// own fd on the .dat; the index starts empty — push entries with
// swhp_put/swhp_put_bulk. Returns 0 ok, -1 open failure.
int swhp_add_volume(void* h, uint32_t vid, const char* dat_path,
                    int version) {
  Server* s = static_cast<Server*>(h);
  int fd = open(dat_path, O_RDONLY);
  if (fd < 0) return -1;
  auto rec = std::make_shared<VolumeRec>();
  rec->fd = fd;
  rec->version = version;
  rec->dat_path = dat_path;
  std::unique_lock<std::shared_mutex> l(s->vols_mu);
  s->vols[vid] = std::move(rec);
  return 0;
}

// Hands this library the volume's write lease: O_RDWR on the .dat
// (appends at `tail`), O_APPEND on the .idx. While enabled, Python
// routes every append through swhp_append and treats the mirror index
// as authoritative. accept_posts additionally opens the fast-path POST
// handler (off for replicated/TTL'd/JWT-guarded volumes — those write
// shapes stay with Python, which still delegates the final append).
int swhp_enable_writer(void* h, uint32_t vid, const char* idx_path,
                       int offset_width, int64_t tail, int64_t max_size,
                       int64_t file_size_limit, int accept_posts) {
  Server* s = static_cast<Server*>(h);
  auto vol = s->find(vid);
  if (!vol || tail % 8 != 0) return -1;
  auto w = std::make_shared<Writer>();
  w->fd = open(vol->dat_path.c_str(), O_RDWR);
  if (w->fd < 0) return -1;
  w->idx_fd = open(idx_path, O_WRONLY | O_APPEND);
  if (w->idx_fd < 0) return -1;
  w->offset_width = offset_width;
  w->tail.store(tail);
  w->idx_tail = lseek(w->idx_fd, 0, SEEK_END);
  w->max_size = max_size;
  w->file_size_limit = file_size_limit;
  w->accept_posts.store(accept_posts != 0, std::memory_order_release);
  // freeze the server's configured durability mode into this lease
  // (a live lease's mode never mutates under in-flight appends). The
  // committer gets private dup'd fds so a fail-stop closing the
  // writer's fds can't invalidate an in-flight fdatasync.
  w->srv = s;
  w->sync_mode = s->sync_mode.load();
  w->batch_us = s->sync_batch_us.load();
  uint64_t mp = s->sync_max_pending.load();
  w->max_pending = mp ? mp : 1;
  if (w->sync_mode == 1) {
    w->sync_dat_fd = dup(w->fd);
    w->sync_idx_fd = dup(w->idx_fd);
    if (w->sync_dat_fd < 0 || w->sync_idx_fd < 0) return -1;
    w->committer = std::thread(committer_loop, s, w.get());
  }
  std::unique_lock<std::shared_mutex> l(vol->mu);
  vol->writer = std::move(w);
  return 0;
}

// Takes the lease back. Acquiring the writer mutex before closing the
// fds is the barrier: once this returns, no append is in flight and
// none can start, so Python may reload its needle map from the .idx
// and resume its own appends. Returns the final tail (-1: no writer).
int64_t swhp_disable_writer(void* h, uint32_t vid) {
  Server* s = static_cast<Server*>(h);
  auto vol = s->find(vid);
  if (!vol) return -1;
  std::shared_ptr<Writer> w;
  {
    std::unique_lock<std::shared_mutex> l(vol->mu);
    w = std::move(vol->writer);
    vol->writer.reset();
  }
  if (!w) return -1;
  w->accept_posts.store(false, std::memory_order_release);
  // committer teardown FIRST: its final fdatasync drains every pending
  // sequence, so appends enqueued before the stop get their durable
  // acks (a lease handback must never leak an acked-but-unsynced
  // window); an append racing in after the stop poisons itself to -5
  // instead of enqueueing. Only then does taking `mu` below become the
  // usual no-append-in-flight barrier.
  w->stop_committer();
  std::lock_guard<std::mutex> g(w->mu);
  int64_t tail = w->tail.load();
  if (w->fd >= 0) close(w->fd);
  if (w->idx_fd >= 0) close(w->idx_fd);
  w->fd = w->idx_fd = -1;
  return tail;
}

int swhp_set_accept_posts(void* h, uint32_t vid, int on) {
  Server* s = static_cast<Server*>(h);
  auto vol = s->find(vid);
  if (!vol) return -1;
  auto w = vol->get_writer();
  if (!w) return -1;
  w->accept_posts.store(on != 0, std::memory_order_release);
  return 0;
}

// Python's delegated append (write_needle / delete_needle build the
// record — TTLs, pairs, manifests and all — and hand the bytes here so
// the volume keeps exactly one tail writer). size_field is the header
// Size (kTombstoneSize for deletes). check_cookie re-verifies the
// overwrite/delete cookie against the stored needle under the append
// mutex (Python's own pre-check races with fast-path POSTs).
// Returns the offset or the do_append error code.
int64_t swhp_append(void* h, uint32_t vid, const uint8_t* blob,
                    int64_t len, uint64_t key, uint32_t size_field,
                    int check_cookie, uint32_t cookie) {
  Server* s = static_cast<Server*>(h);
  auto vol = s->find(vid);
  if (!vol) return -1;
  auto w = vol->get_writer();
  if (!w) return -1;
  return do_append(vol.get(), w.get(), blob, len, key, size_field,
                   check_cookie != 0, cookie);
}

// Mirror-index probe (1 found, 0 absent). In writer mode the mirror is
// exact, so Python's read/delete/overwrite paths use this instead of
// their (frozen) needle map.
int swhp_lookup(void* h, uint32_t vid, uint64_t key, uint64_t* offset,
                uint32_t* size) {
  Server* s = static_cast<Server*>(h);
  auto vol = s->find(vid);
  if (!vol) return 0;
  std::shared_lock<std::shared_mutex> l(vol->mu);
  auto it = vol->index.find(key);
  if (it == vol->index.end()) return 0;
  *offset = it->second.first;
  *size = it->second.second;
  return 1;
}

// Counter deltas since enable: puts, put_bytes, deletes, deleted_bytes,
// max_key, tail (in that order). Python adds them to its needle-map
// counters for heartbeats/vacuum decisions while the lease is out.
int swhp_writer_counters(void* h, uint32_t vid, uint64_t out[6]) {
  Server* s = static_cast<Server*>(h);
  auto vol = s->find(vid);
  if (!vol) return -1;
  auto w = vol->get_writer();
  if (!w) return -1;
  out[0] = w->puts.load();
  out[1] = w->put_bytes.load();
  out[2] = w->deletes.load();
  out[3] = w->deleted_bytes.load();
  out[4] = w->max_key.load();
  // lock-free: heartbeats read counters five times per volume and must
  // not contend with in-flight appends
  out[5] = static_cast<uint64_t>(w->tail.load());
  return 0;
}

int swhp_remove_volume(void* h, uint32_t vid) {
  Server* s = static_cast<Server*>(h);
  swhp_disable_writer(h, vid);  // mutex barrier before the rec can die
  std::unique_lock<std::shared_mutex> l(s->vols_mu);
  return s->vols.erase(vid) ? 0 : -1;
}

int swhp_put(void* h, uint32_t vid, uint64_t key, uint64_t offset,
             uint32_t size) {
  Server* s = static_cast<Server*>(h);
  auto vol = s->find(vid);
  if (!vol) return -1;
  std::unique_lock<std::shared_mutex> l(vol->mu);
  vol->index[key] = {offset, size};
  return 0;
}

// Bulk load: parallel arrays (numpy-friendly). Insert-only: a key that
// raced in via swhp_put between Python's needle-map snapshot and this
// load is FRESHER than the snapshot — overwriting it would serve the
// pre-overwrite offset until that key's next write.
int swhp_put_bulk(void* h, uint32_t vid, const uint64_t* keys,
                  const uint64_t* offsets, const uint32_t* sizes,
                  int64_t count) {
  Server* s = static_cast<Server*>(h);
  auto vol = s->find(vid);
  if (!vol) return -1;
  std::unique_lock<std::shared_mutex> l(vol->mu);
  vol->index.reserve(vol->index.size() + static_cast<size_t>(count));
  for (int64_t i = 0; i < count; i++)
    vol->index.emplace(keys[i], std::make_pair(offsets[i], sizes[i]));
  return 0;
}

int swhp_delete(void* h, uint32_t vid, uint64_t key) {
  Server* s = static_cast<Server*>(h);
  auto vol = s->find(vid);
  if (!vol) return -1;
  std::unique_lock<std::shared_mutex> l(vol->mu);
  vol->index.erase(key);
  return 0;
}

uint64_t swhp_served(void* h) { return static_cast<Server*>(h)->served; }
uint64_t swhp_redirected(void* h) {
  return static_cast<Server*>(h)->redirected;
}
uint64_t swhp_written(void* h) { return static_cast<Server*>(h)->written; }

// ---- hot-path telemetry ------------------------------------------------

// Flat snapshot of the plane's request telemetry (one relaxed load per
// slot — values from concurrent requests may be mutually torn, which is
// fine for monotonic counters). Layout, all uint64:
//   [0] requests_total          [1..5] status classes 1xx..5xx
//   [6] bytes_sent              [7] redirects_to_python
//   [8] index_misses            [9] latency observation count
//   [10] latency sum (µs)       [11..] per-bucket counts, last = +Inf
// Returns the number of values written, -1 if `out` is too small
// (size with swhp_stats_len()).
int swhp_stats_len() { return 11 + kLatBuckets + 1; }

int swhp_stats(void* h, uint64_t* out, int n) {
  if (!h || n < 11 + kLatBuckets + 1) return -1;
  Server* s = static_cast<Server*>(h);
  PlaneStats& st = s->stats;
  out[0] = st.requests.load(std::memory_order_relaxed);
  for (int c = 1; c <= 5; c++)
    out[c] = st.by_class[c].load(std::memory_order_relaxed);
  out[6] = st.bytes_sent.load(std::memory_order_relaxed);
  out[7] = s->redirected.load(std::memory_order_relaxed);
  out[8] = st.index_misses.load(std::memory_order_relaxed);
  out[9] = st.lat_count.load(std::memory_order_relaxed);
  out[10] = st.lat_sum_us.load(std::memory_order_relaxed);
  for (int b = 0; b <= kLatBuckets; b++)
    out[11 + b] = st.lat_buckets[b].load(std::memory_order_relaxed);
  return 11 + kLatBuckets + 1;
}

// µs upper bounds of the latency buckets (the +Inf bucket is implicit).
int swhp_lat_bounds(uint64_t* out, int n) {
  if (!out || n < kLatBuckets) return -1;
  for (int b = 0; b < kLatBuckets; b++) out[b] = kLatBoundsUs[b];
  return kLatBuckets;
}

void swhp_set_stats_enabled(void* h, int on) {
  static_cast<Server*>(h)->stats.enabled.store(
      on != 0, std::memory_order_relaxed);
}

void swhp_set_slow_us(void* h, uint64_t us) {
  static_cast<Server*>(h)->stats.slow_us.store(
      us, std::memory_order_relaxed);
}

// Newest-first JSON array of the slow-request ring. Writes at most
// buflen-1 bytes plus a NUL; returns the body length, or -1 when the
// buffer cannot hold the whole ring (callers pass 64 KB — 64 entries
// at ~300 bytes each always fit).
int swhp_slow_ring(void* h, char* buf, int buflen) {
  if (!h || !buf || buflen < 3) return -1;
  PlaneStats& st = static_cast<Server*>(h)->stats;
  auto jsonable = [](const char* in) {
    // targets/methods are raw wire bytes: escape quotes/backslashes and
    // blank out control chars so the ring always parses as JSON
    std::string out;
    for (const char* p = in; *p; p++) {
      unsigned char c = static_cast<unsigned char>(*p);
      if (c == '"' || c == '\\') {
        out.push_back('\\');
        out.push_back(*p);
      } else if (c < 0x20) {
        out.push_back('?');
      } else {
        out.push_back(*p);
      }
    }
    return out;
  };
  std::string out = "[";
  {
    std::lock_guard<std::mutex> g(st.slow_mu);
    uint64_t have = std::min<uint64_t>(st.slow_seq, kSlowRing);
    for (uint64_t i = 0; i < have; i++) {
      const SlowEntry& e = st.slow[(st.slow_seq - 1 - i) % kSlowRing];
      char item[320];
      snprintf(item, sizeof item,
               "%s{\"method\": \"%s\", \"target\": \"%s\", "
               "\"status\": %d, \"bytes\": %llu, \"micros\": %llu, "
               "\"unix_ms\": %llu}",
               i ? ", " : "", jsonable(e.method).c_str(),
               jsonable(e.target).c_str(), e.status,
               static_cast<unsigned long long>(e.bytes),
               static_cast<unsigned long long>(e.micros),
               static_cast<unsigned long long>(e.unix_ms));
      out += item;
    }
  }
  out += "]";
  if (out.size() + 1 > static_cast<size_t>(buflen)) return -1;
  memcpy(buf, out.data(), out.size());
  buf[out.size()] = '\0';
  return static_cast<int>(out.size());
}

// ---- group-commit durability -------------------------------------------

// Configures the durability mode applied to writers at enable time
// (SW_PLANE_FSYNC_MODE): 0 = off (ack from the page cache — the
// pre-durability behavior), 1 = group (a committer amortizes ONE
// fdatasync per commit window over every rider), 2 = always (fdatasync
// per append — the baseline group mode is measured against). batch_us
// is the commit window, max_pending the rider count forcing an early
// commit. Live leases keep the mode they were enabled with; Python
// cycles the lease to apply a change. Returns 0, -1 on a bad mode.
int swhp_set_sync_mode(void* h, int mode, uint64_t batch_us,
                       uint64_t max_pending) {
  if (!h || mode < 0 || mode > 2) return -1;
  Server* s = static_cast<Server*>(h);
  s->sync_mode.store(mode);
  s->sync_batch_us.store(batch_us);
  s->sync_max_pending.store(max_pending ? max_pending : 1);
  return 0;
}

// Flat snapshot of the durability telemetry, all uint64:
//   [0] mode        [1] batch_us     [2] max_pending
//   [3] batches     [4] riders       [5] fsync_failures
//   [6] pending     [7] fsync µs sum
//   [8..] per-bucket fsync µs counts (bounds = swhp_lat_bounds, last =
//         +Inf); the µs sum and buckets flow only while stats are
//         enabled — SW_PLANE_STATS=0 keeps the committer clock-free.
int swhp_sync_stats_len() { return 8 + kLatBuckets + 1; }

int swhp_sync_stats(void* h, uint64_t* out, int n) {
  if (!h || n < 8 + kLatBuckets + 1) return -1;
  Server* s = static_cast<Server*>(h);
  out[0] = static_cast<uint64_t>(s->sync_mode.load());
  out[1] = s->sync_batch_us.load();
  out[2] = s->sync_max_pending.load();
  out[3] = s->fsync_batches.load(std::memory_order_relaxed);
  out[4] = s->fsync_riders.load(std::memory_order_relaxed);
  out[5] = s->fsync_failures.load(std::memory_order_relaxed);
  out[6] = s->fsync_pending.load(std::memory_order_relaxed);
  out[7] = s->fsync_us_sum.load(std::memory_order_relaxed);
  for (int b = 0; b <= kLatBuckets; b++)
    out[8 + b] = s->fsync_buckets[b].load(std::memory_order_relaxed);
  return 8 + kLatBuckets + 1;
}

// ---- EC volumes + reconstructed-slab cache -----------------------------

// Registers (or re-registers after a mount change) an EC volume's
// striping geometry. The index starts empty — push .ecx entries with
// swhp_ec_put_bulk, attach local shard files with swhp_ec_set_shard.
// dat_size is the ORIGINAL .dat size (drives the encoder-exact
// large/small row split); slab_bytes must equal the Python engine's
// SW_EC_DEGRADED_SLAB_BYTES or cached slabs will be mis-addressed.
int swhp_ec_register(void* h, uint32_t vid, int version, int64_t dat_size,
                     int64_t large_block, int64_t small_block,
                     int64_t slab_bytes) {
  if (!h || dat_size <= 0 || large_block <= 0 || small_block <= 0 ||
      slab_bytes <= 0)
    return -1;
  Server* s = static_cast<Server*>(h);
  auto rec = std::make_shared<EcVolumeRec>();
  rec->version = version;
  rec->dat_size = dat_size;
  rec->large_block = large_block;
  rec->small_block = small_block;
  rec->slab_bytes = slab_bytes;
  std::unique_lock<std::shared_mutex> l(s->ec_mu);
  s->ec_vols[vid] = std::move(rec);
  return 0;
}

// Attaches (path non-empty) or detaches (path null/empty) a local shard
// file. A detached data shard is "lost" from the plane's viewpoint: its
// bytes must come from the slab cache or the request redirects.
int swhp_ec_set_shard(void* h, uint32_t vid, int sid,
                      const char* shard_path) {
  if (sid < 0 || sid >= kMaxEcShards) return -1;
  Server* s = static_cast<Server*>(h);
  auto ev = s->find_ec(vid);
  if (!ev) return -1;
  int fd = -1;
  if (shard_path && *shard_path) {
    fd = open(shard_path, O_RDONLY);
    if (fd < 0) return -1;
  }
  std::unique_lock<std::shared_mutex> l(ev->mu);
  if (ev->shard_fds[sid] >= 0) close(ev->shard_fds[sid]);
  ev->shard_fds[sid] = fd;
  return 0;
}

// Bulk .ecx index push: parallel arrays of key / BYTE offset in the
// logical .dat / size. Assign (not insert-only): the EC index mirrors a
// point-in-time .ecx snapshot taken under Python's ecx lock, and
// tombstones are pushed as kTombstoneSize entries rather than omitted.
int swhp_ec_put_bulk(void* h, uint32_t vid, const uint64_t* keys,
                     const uint64_t* offsets, const uint32_t* sizes,
                     int64_t count) {
  Server* s = static_cast<Server*>(h);
  auto ev = s->find_ec(vid);
  if (!ev) return -1;
  std::unique_lock<std::shared_mutex> l(ev->mu);
  ev->index.reserve(ev->index.size() + static_cast<size_t>(count));
  for (int64_t i = 0; i < count; i++)
    ev->index[keys[i]] = {offsets[i], sizes[i]};
  return 0;
}

// Mirrors an EC delete: tombstone (not erase), matching the in-place
// .ecx tombstone Python just wrote.
int swhp_ec_delete(void* h, uint32_t vid, uint64_t key) {
  Server* s = static_cast<Server*>(h);
  auto ev = s->find_ec(vid);
  if (!ev) return -1;
  std::unique_lock<std::shared_mutex> l(ev->mu);
  auto it = ev->index.find(key);
  if (it != ev->index.end()) it->second.second = kTombstoneSize;
  return 0;
}

uint64_t swhp_cache_invalidate(void* h, uint32_t vid, int sid);

int swhp_ec_unregister(void* h, uint32_t vid) {
  Server* s = static_cast<Server*>(h);
  {
    std::unique_lock<std::shared_mutex> l(s->ec_mu);
    if (!s->ec_vols.erase(vid)) return -1;
  }
  // defense in depth: Python invalidates explicitly on mount/rebuild,
  // but a dropped registration must never strand stale slabs either
  swhp_cache_invalidate(h, vid, -1);
  return 0;
}

// Sets the cache byte budget (SW_PLANE_CACHE_BYTES); shrinking evicts
// down immediately. 0 disables the cache (and with it the in-plane
// degraded path — every lost-shard read misses and redirects).
void swhp_cache_configure(void* h, uint64_t max_bytes) {
  SlabCache& c = static_cast<Server*>(h)->cache;
  std::lock_guard<std::mutex> g(c.mu);
  c.max_bytes = max_bytes;
  c.evict_to_budget();
}

// Publishes one reconstructed slab (overwriting any prior entry). len 0
// is valid — a past-tail slab cached as "known empty" so reads covering
// it stay in-plane. Returns 0 ok, -1 rejected (cache disabled or the
// slab alone exceeds the whole budget).
int swhp_cache_put(void* h, uint32_t vid, int sid, uint64_t idx,
                   const uint8_t* data, uint64_t len) {
  if (sid < 0 || sid >= kMaxEcShards || (len > 0 && !data)) return -1;
  SlabCache& c = static_cast<Server*>(h)->cache;
  auto blob = std::make_shared<std::vector<uint8_t>>(data, data + len);
  SlabKey k{static_cast<uint64_t>(vid) << 32 | static_cast<uint32_t>(sid),
            idx};
  std::lock_guard<std::mutex> g(c.mu);
  if (c.max_bytes == 0 || len > c.max_bytes) return -1;
  auto it = c.map.find(k);
  if (it != c.map.end()) {
    c.bytes -= it->second->second->size();
    c.lru.erase(it->second);
    c.map.erase(it);
  }
  c.lru.emplace_front(k, std::move(blob));
  c.map[k] = c.lru.begin();
  c.bytes += len;
  c.puts++;
  c.put_bytes += len;
  c.evict_to_budget();
  return 0;
}

// Drops every slab of (vid, sid), or of the whole vid when sid < 0.
// Returns the number of entries removed. In-flight reads that already
// grabbed a slab's shared_ptr finish with the bytes they started with —
// callers serialize rebuild-then-invalidate-then-serve ordering above.
uint64_t swhp_cache_invalidate(void* h, uint32_t vid, int sid) {
  SlabCache& c = static_cast<Server*>(h)->cache;
  uint64_t vs = static_cast<uint64_t>(vid) << 32 |
                static_cast<uint32_t>(sid < 0 ? 0 : sid);
  uint64_t removed = 0;
  std::lock_guard<std::mutex> g(c.mu);
  for (auto it = c.lru.begin(); it != c.lru.end();) {
    bool match = sid < 0 ? (it->first.vs >> 32) == vid : it->first.vs == vs;
    if (match) {
      c.bytes -= it->second->size();
      c.map.erase(it->first);
      it = c.lru.erase(it);
      removed++;
    } else {
      ++it;
    }
  }
  c.invalidated += removed;
  return removed;
}

// Flat snapshot of the slab cache + EC serving outcomes, all uint64:
//   [0] puts        [1] put_bytes   [2] hits         [3] misses
//   [4] evictions   [5] invalidated [6] entries      [7] bytes
//   [8] max_bytes   [9] degraded_served (in-plane, cache-fed)
//   [10] degraded_redirected (lost shard, slabs absent or bad)
//   [11] ec_local_served (all shards local)
// The first nine are one consistent snapshot (taken under the cache
// mutex — exact, not torn); the last three are relaxed atomics.
int swhp_cache_stats_len() { return 12; }

int swhp_cache_stats(void* h, uint64_t* out, int n) {
  if (!h || n < 12) return -1;
  Server* s = static_cast<Server*>(h);
  SlabCache& c = s->cache;
  {
    std::lock_guard<std::mutex> g(c.mu);
    out[0] = c.puts;
    out[1] = c.put_bytes;
    out[2] = c.hits;
    out[3] = c.misses;
    out[4] = c.evictions;
    out[5] = c.invalidated;
    out[6] = c.map.size();
    out[7] = c.bytes;
    out[8] = c.max_bytes;
  }
  out[9] = s->ec_degraded_served.load(std::memory_order_relaxed);
  out[10] = s->ec_degraded_redirected.load(std::memory_order_relaxed);
  out[11] = s->ec_local_served.load(std::memory_order_relaxed);
  return 12;
}

void swhp_stop(void* h) {
  Server* s = static_cast<Server*>(h);
  s->stop = true;
  shutdown(s->listen_fd, SHUT_RDWR);
  close(s->listen_fd);
  if (s->acceptor.joinable()) s->acceptor.join();
  {
    std::lock_guard<std::mutex> g(s->conns_mu);
    for (int fd : s->conns) shutdown(fd, SHUT_RDWR);
  }
  // give in-flight connection threads a beat to observe stop and finish
  for (int i = 0; i < 200 && s->live.load() > 0; i++)
    usleep(10000);
  // Leak s if connections are stuck: a crash on a wedged shutdown is
  // worse than 1KB at process exit.
  if (s->live.load() == 0) delete s;
}

}  // extern "C"
