// egress_core — the host egress data plane of easydarwin_tpu_torch (see
// egress_core.h).  Host C++, not a kernel: it carries the relay's wire
// writes, the megabatch upload gather, the UDP pusher ingest and the
// io_uring capability probe.
#include "egress_core.h"

#include <arpa/inet.h>
#include <netinet/in.h>
#include <netinet/udp.h>
#include <sys/mman.h>
#include <sys/socket.h>
#include <sys/syscall.h>
#include <sys/uio.h>
#include <unistd.h>

#include <algorithm>
#include <atomic>
#include <cerrno>
#include <cstring>
#include <ctime>
#include <map>
#include <vector>

namespace {

constexpr int kSendBatch = 512;
constexpr int kRecvBatch = 64;

inline void render_header(uint8_t *dst, const uint8_t *src, uint32_t seq_off,
                          uint32_t ts_off, uint32_t ssrc) {
  dst[0] = src[0];  // V/P/X/CC and M/PT verbatim
  dst[1] = src[1];
  uint16_t seq = static_cast<uint16_t>((src[2] << 8) | src[3]);
  seq = static_cast<uint16_t>(seq + seq_off);
  dst[2] = static_cast<uint8_t>(seq >> 8);
  dst[3] = static_cast<uint8_t>(seq);
  uint32_t ts = (static_cast<uint32_t>(src[4]) << 24) |
                (static_cast<uint32_t>(src[5]) << 16) |
                (static_cast<uint32_t>(src[6]) << 8) | src[7];
  ts += ts_off;
  dst[4] = static_cast<uint8_t>(ts >> 24);
  dst[5] = static_cast<uint8_t>(ts >> 16);
  dst[6] = static_cast<uint8_t>(ts >> 8);
  dst[7] = static_cast<uint8_t>(ts);
  dst[8] = static_cast<uint8_t>(ssrc >> 24);
  dst[9] = static_cast<uint8_t>(ssrc >> 16);
  dst[10] = static_cast<uint8_t>(ssrc >> 8);
  dst[11] = static_cast<uint8_t>(ssrc);
}

// Why the last send stopped short; a partial count alone cannot tell flow
// control from a hard error.
thread_local int g_stop_errno = 0;

struct StatCells {
  std::atomic<int64_t> sendmmsg_calls{0}, send_packets{0},
      gso_supers{0}, gso_segments{0}, eagain_stops{0}, hard_errors{0},
      bytes_to_wire{0}, send_ns{0}, stage_gather_ns{0}, staged_bytes{0},
      fault_injections{0}, stream_writev_calls{0}, stream_packets{0},
      stream_bytes{0}, recvmmsg_calls{0}, recv_packets{0}, recv_bytes{0},
      oversize_dropped{0}, ingest_ns{0};
};
StatCells g_stat;

inline void stat_add(std::atomic<int64_t> &c, int64_t v) {
  c.fetch_add(v, std::memory_order_relaxed);
}

// A stopped send still issued its syscall, so callers count the call too.
inline void note_send_stop(int err) {
  if (err == EAGAIN || err == EWOULDBLOCK)
    stat_add(g_stat.eagain_stops, 1);
  else
    stat_add(g_stat.hard_errors, 1);
}

inline int64_t mono_ns() {
  timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return static_cast<int64_t>(ts.tv_sec) * 1000000000 + ts.tv_nsec;
}

// Adds the entry point's wall time to one counter on every exit path.
struct StatTimer {
  std::atomic<int64_t> &cell;
  int64_t t0;
  explicit StatTimer(std::atomic<int64_t> &c) : cell(c), t0(mono_ns()) {}
  ~StatTimer() { stat_add(cell, mono_ns() - t0); }
};

struct FaultCells {
  std::atomic<int64_t> eagain_every{0}, enobufs_every{0}, latency_every{0},
      latency_us{0};
  std::atomic<int64_t> eagain_calls{0}, enobufs_calls{0}, latency_calls{0};
};
FaultCells g_fault;

inline bool fault_due(std::atomic<int64_t> &every,
                      std::atomic<int64_t> &calls) {
  const int64_t n = every.load(std::memory_order_relaxed);
  if (n <= 0) return false;
  const int64_t c = calls.fetch_add(1, std::memory_order_relaxed) + 1;
  return c % n == 0;
}

// Run before each egress syscall attempt: 0 = proceed, or the errno the
// attempt fails with, so an injected fault takes the real error path.
inline int fault_egress_gate() {
  if (fault_due(g_fault.latency_every, g_fault.latency_calls)) {
    stat_add(g_stat.fault_injections, 1);
    const int64_t us = g_fault.latency_us.load(std::memory_order_relaxed);
    if (us > 0) {
      timespec ts{us / 1000000, (us % 1000000) * 1000};
      nanosleep(&ts, nullptr);
    }
  }
  if (fault_due(g_fault.eagain_every, g_fault.eagain_calls)) {
    stat_add(g_stat.fault_injections, 1);
    return EAGAIN;
  }
  if (fault_due(g_fault.enobufs_every, g_fault.enobufs_calls)) {
    stat_add(g_stat.fault_injections, 1);
    return ENOBUFS;
  }
  return 0;
}

inline void fill_addr(sockaddr_in &sa, const ed_dest &d) {
  std::memset(&sa, 0, sizeof(sa));
  sa.sin_family = AF_INET;
  sa.sin_addr.s_addr = d.ip_be;
  sa.sin_port = d.port_be;
}

}  // namespace

extern "C" {

int32_t ed_last_send_errno(void) { return g_stop_errno; }

void ed_get_stats(ed_stats *out) {
  const auto ld = [](const std::atomic<int64_t> &c) {
    return c.load(std::memory_order_relaxed);
  };
  out->sendmmsg_calls = ld(g_stat.sendmmsg_calls);
  out->send_packets = ld(g_stat.send_packets);
  out->gso_supers = ld(g_stat.gso_supers);
  out->gso_segments = ld(g_stat.gso_segments);
  out->eagain_stops = ld(g_stat.eagain_stops);
  out->hard_errors = ld(g_stat.hard_errors);
  out->bytes_to_wire = ld(g_stat.bytes_to_wire);
  out->send_ns = ld(g_stat.send_ns);
  out->stage_gather_ns = ld(g_stat.stage_gather_ns);
  out->staged_bytes = ld(g_stat.staged_bytes);
  out->fault_injections = ld(g_stat.fault_injections);
  out->stream_writev_calls = ld(g_stat.stream_writev_calls);
  out->stream_packets = ld(g_stat.stream_packets);
  out->stream_bytes = ld(g_stat.stream_bytes);
  out->recvmmsg_calls = ld(g_stat.recvmmsg_calls);
  out->recv_packets = ld(g_stat.recv_packets);
  out->recv_bytes = ld(g_stat.recv_bytes);
  out->oversize_dropped = ld(g_stat.oversize_dropped);
  out->ingest_ns = ld(g_stat.ingest_ns);
}

// Every field is int64, so the count follows the struct by construction.
int32_t ed_stats_fields(void) {
  return static_cast<int32_t>(sizeof(ed_stats) / sizeof(int64_t));
}

void ed_reset_stats(void) {
  for (std::atomic<int64_t> *c :
       {&g_stat.sendmmsg_calls, &g_stat.send_packets,
        &g_stat.gso_supers, &g_stat.gso_segments, &g_stat.eagain_stops,
        &g_stat.hard_errors, &g_stat.bytes_to_wire, &g_stat.send_ns,
        &g_stat.stage_gather_ns, &g_stat.staged_bytes,
        &g_stat.fault_injections, &g_stat.stream_writev_calls,
        &g_stat.stream_packets, &g_stat.stream_bytes,
        &g_stat.recvmmsg_calls, &g_stat.recv_packets, &g_stat.recv_bytes,
        &g_stat.oversize_dropped, &g_stat.ingest_ns})
    c->store(0, std::memory_order_relaxed);
}

void ed_fault_set(int64_t eagain_every, int64_t enobufs_every,
                  int64_t latency_every, int64_t latency_us) {
  g_fault.eagain_every.store(eagain_every, std::memory_order_relaxed);
  g_fault.enobufs_every.store(enobufs_every, std::memory_order_relaxed);
  g_fault.latency_every.store(latency_every, std::memory_order_relaxed);
  g_fault.latency_us.store(latency_us, std::memory_order_relaxed);
  g_fault.eagain_calls.store(0, std::memory_order_relaxed);
  g_fault.enobufs_calls.store(0, std::memory_order_relaxed);
  g_fault.latency_calls.store(0, std::memory_order_relaxed);
}

void ed_fault_clear(void) { ed_fault_set(0, 0, 0, 0); }

// One source row's ops through plain sendmmsg, kSendBatch at a time.
static int32_t send_udp_plain(int fd, const uint8_t *ring_data,
                              const int32_t *ring_len, int32_t capacity,
                              int32_t slot_size, const uint32_t *seq_off,
                              const uint32_t *ts_off, const uint32_t *ssrc,
                              const ed_dest *dest, int32_t n_outs,
                              const ed_sendop *ops, int32_t n_ops) {
  g_stop_errno = 0;
  if (n_ops <= 0) return 0;
  StatTimer timer(g_stat.send_ns);
  std::vector<mmsghdr> msgs(kSendBatch);
  std::vector<iovec> iovs(static_cast<size_t>(kSendBatch) * 2);
  std::vector<sockaddr_in> addrs(kSendBatch);
  std::vector<uint8_t> hdrs(static_cast<size_t>(kSendBatch) * 12);
  std::vector<int32_t> blens(kSendBatch);

  int32_t done = 0;
  while (done < n_ops) {
    int batch = 0;
    for (; batch < kSendBatch && done + batch < n_ops; ++batch) {
      const ed_sendop &op = ops[done + batch];
      if (op.slot < 0 || op.slot >= capacity || op.out < 0 ||
          op.out >= n_outs)
        return -EINVAL;
      const uint8_t *pkt = ring_data + static_cast<size_t>(op.slot) * slot_size;
      const int32_t len = ring_len[op.slot];
      if (len < 12 || len > slot_size) return -EINVAL;
      blens[batch] = len;
      uint8_t *h = hdrs.data() + static_cast<size_t>(batch) * 12;
      render_header(h, pkt, seq_off[op.out], ts_off[op.out], ssrc[op.out]);
      iovec *iv = &iovs[static_cast<size_t>(batch) * 2];
      iv[0].iov_base = h;
      iv[0].iov_len = 12;
      iv[1].iov_base = const_cast<uint8_t *>(pkt) + 12;
      iv[1].iov_len = static_cast<size_t>(len - 12);
      fill_addr(addrs[batch], dest[op.out]);
      mmsghdr &m = msgs[batch];
      std::memset(&m, 0, sizeof(m));
      m.msg_hdr.msg_name = &addrs[batch];
      m.msg_hdr.msg_namelen = sizeof(sockaddr_in);
      m.msg_hdr.msg_iov = iv;
      m.msg_hdr.msg_iovlen = 2;
    }
    int sent = 0;
    while (sent < batch) {
      const int ferr = fault_egress_gate();
      if (ferr) {
        g_stop_errno = ferr;
        stat_add(g_stat.sendmmsg_calls, 1);
        note_send_stop(ferr);
        const int32_t got = done + sent;
        if (ferr == EAGAIN) return got;
        return got > 0 ? got : -ferr;
      }
      const int n = sendmmsg(fd, msgs.data() + sent, batch - sent, 0);
      if (n < 0) {
        if (errno == EINTR) continue;
        const int err = errno;
        g_stop_errno = err;
        stat_add(g_stat.sendmmsg_calls, 1);
        note_send_stop(err);
        const int32_t got = done + sent;
        if (err == EAGAIN || err == EWOULDBLOCK) return got;
        // a hard stop reports what was delivered: callers advance past it
        // and never send a delivered datagram again
        return got > 0 ? got : -err;
      }
      stat_add(g_stat.sendmmsg_calls, 1);
      stat_add(g_stat.send_packets, n);
      int64_t nb = 0;
      for (int i = sent; i < sent + n; ++i) nb += blens[i];
      stat_add(g_stat.bytes_to_wire, nb);
      sent += n;
    }
    done += batch;
  }
  return done;
}

#ifndef UDP_SEGMENT
#define UDP_SEGMENT 103
#endif
#ifndef UDP_MAX_SEGMENTS
#define UDP_MAX_SEGMENTS 64
#endif

// One source row's ops with same-subscriber, same-size runs coalesced into
// UDP_SEGMENT super-datagrams, kSupers of them a sendmmsg.
static int32_t send_udp_gso(int fd, const uint8_t *ring_data,
                            const int32_t *ring_len, int32_t capacity,
                            int32_t slot_size, const uint32_t *seq_off,
                            const uint32_t *ts_off, const uint32_t *ssrc,
                            const ed_dest *dest, int32_t n_outs,
                            const ed_sendop *ops, int32_t n_ops) {
  g_stop_errno = 0;
  if (n_ops <= 0) return 0;
  StatTimer timer(g_stat.send_ns);
  constexpr int kSupers = 64;              // super-sends per sendmmsg
  constexpr size_t kMaxGsoBytes = 65000;   // below the UDP payload ceiling
  struct Super {
    sockaddr_in sa;
    alignas(cmsghdr) char ctl[CMSG_SPACE(sizeof(uint16_t))];
    int n_segs = 0;
    int64_t bytes = 0;
  };
  static thread_local std::vector<mmsghdr> msgs(kSupers);
  static thread_local std::vector<Super> supers(kSupers);
  static thread_local std::vector<iovec> iovs(
      static_cast<size_t>(kSupers) * 2 * UDP_MAX_SEGMENTS);
  static thread_local std::vector<uint8_t> hdrs(
      static_cast<size_t>(kSupers) * UDP_MAX_SEGMENTS * 12);
  size_t iov_used = 0, hdr_used = 0;
  int32_t done = 0;    // ops handed to the kernel
  int32_t staged = 0;  // ops rendered into the pending flush
  int n_super = 0;
  int flush_err = 0;   // hard errno of the last flush

  // Returns the ops handed to the kernel (a partly sent flush counts what
  // went), so a caller retrying the rest never sends a datagram twice.
  auto flush = [&]() -> int32_t {
    int sent = 0;
    flush_err = 0;
    const auto ops_in = [&](int k) {
      int32_t s = 0;
      for (int i = 0; i < k; ++i) s += supers[i].n_segs;
      return s;
    };
    while (sent < n_super) {
      const int ferr = fault_egress_gate();
      if (ferr) {
        g_stop_errno = ferr;
        stat_add(g_stat.sendmmsg_calls, 1);
        note_send_stop(ferr);
        if (ferr != EAGAIN) flush_err = ferr;
        return ops_in(sent);
      }
      const int n = sendmmsg(fd, msgs.data() + sent, n_super - sent, 0);
      if (n < 0) {
        if (errno == EINTR) continue;
        const int err = errno;
        g_stop_errno = err;
        stat_add(g_stat.sendmmsg_calls, 1);
        // EINVAL/EOPNOTSUPP here means no UDP GSO in this kernel: a
        // capability answer the caller handles, not a destination error
        if (err != EINVAL && err != EOPNOTSUPP) note_send_stop(err);
        if (err != EAGAIN && err != EWOULDBLOCK) flush_err = err;
        return ops_in(sent);
      }
      stat_add(g_stat.sendmmsg_calls, 1);
      int64_t pk = 0, nb = 0, sup = 0, seg = 0;
      for (int i = sent; i < sent + n; ++i) {
        pk += supers[i].n_segs;
        nb += supers[i].bytes;
        if (supers[i].n_segs > 1) {
          sup += 1;
          seg += supers[i].n_segs;
        }
      }
      stat_add(g_stat.send_packets, pk);
      stat_add(g_stat.bytes_to_wire, nb);
      stat_add(g_stat.gso_supers, sup);
      stat_add(g_stat.gso_segments, seg);
      sent += n;
    }
    const int32_t all = ops_in(n_super);
    n_super = 0;
    staged = 0;
    iov_used = 0;
    hdr_used = 0;
    return all;
  };

  while (done + staged < n_ops) {
    // a run: consecutive ops of one subscriber, every segment but the last
    // exactly the first one's size
    const ed_sendop &first = ops[done + staged];
    if (first.slot < 0 || first.slot >= capacity || first.out < 0 ||
        first.out >= n_outs)
      return -EINVAL;
    const int32_t gs_len = ring_len[first.slot];
    if (gs_len < 12 || gs_len > slot_size) return -EINVAL;
    const uint16_t gs_size = static_cast<uint16_t>(gs_len);
    Super &sp = supers[n_super];
    sp.n_segs = 0;
    fill_addr(sp.sa, dest[first.out]);
    iovec *run_iov = &iovs[iov_used];
    size_t bytes = 0;
    while (done + staged < n_ops && sp.n_segs < UDP_MAX_SEGMENTS) {
      const ed_sendop &op = ops[done + staged];
      if (op.out != first.out) break;
      if (op.slot < 0 || op.slot >= capacity) return -EINVAL;
      const int32_t len = ring_len[op.slot];
      if (len < 12 || len > slot_size) return -EINVAL;
      if (len > gs_size) break;                  // a longer one starts a run
      if (bytes + static_cast<size_t>(len) > kMaxGsoBytes) break;
      const uint8_t *pkt = ring_data + static_cast<size_t>(op.slot) * slot_size;
      uint8_t *h = hdrs.data() + hdr_used;
      hdr_used += 12;
      render_header(h, pkt, seq_off[op.out], ts_off[op.out], ssrc[op.out]);
      iovec *iv = &iovs[iov_used];
      iov_used += 2;
      iv[0].iov_base = h;
      iv[0].iov_len = 12;
      iv[1].iov_base = const_cast<uint8_t *>(pkt) + 12;
      iv[1].iov_len = static_cast<size_t>(len - 12);
      bytes += static_cast<size_t>(len);
      sp.n_segs++;
      staged++;
      if (len < gs_size) break;                  // a short one ends the run
    }
    sp.bytes = static_cast<int64_t>(bytes);
    mmsghdr &m = msgs[n_super];
    std::memset(&m, 0, sizeof(m));
    m.msg_hdr.msg_name = &sp.sa;
    m.msg_hdr.msg_namelen = sizeof(sp.sa);
    m.msg_hdr.msg_iov = run_iov;
    m.msg_hdr.msg_iovlen = static_cast<size_t>(sp.n_segs) * 2;
    if (sp.n_segs > 1) {
      m.msg_hdr.msg_control = sp.ctl;
      m.msg_hdr.msg_controllen = sizeof(sp.ctl);
      cmsghdr *cm = CMSG_FIRSTHDR(&m.msg_hdr);
      cm->cmsg_level = SOL_UDP;
      cm->cmsg_type = UDP_SEGMENT;
      cm->cmsg_len = CMSG_LEN(sizeof(uint16_t));
      std::memcpy(CMSG_DATA(cm), &gs_size, sizeof(uint16_t));
    }
    n_super++;
    if (n_super == kSupers || iov_used + 2 * UDP_MAX_SEGMENTS > iovs.size()) {
      const int32_t pending = staged;
      const int32_t r = flush();
      done += r;
      if (flush_err) return done > 0 ? done : -flush_err;
      if (r < pending) return done;              // EAGAIN: bookmarks hold
    }
  }
  if (n_super > 0) {
    done += flush();
    if (flush_err && done == 0) return -flush_err;
  }
  return done;
}

int32_t ed_fanout_send_multi(int fd, const uint8_t *ring_data,
                             const int32_t *ring_len, int32_t capacity,
                             int32_t slot_size, const uint32_t *seq_off,
                             const uint32_t *ts_off, const uint32_t *ssrc,
                             int32_t n_src, int32_t param_stride,
                             const ed_dest *dest, int32_t n_outs,
                             const ed_sendop *ops, int32_t n_ops,
                             int32_t use_gso) {
  if (param_stride < n_outs) return -EINVAL;
  int64_t total = 0;
  for (int32_t s = 0; s < n_src; ++s) {
    const size_t row = static_cast<size_t>(s) * param_stride;
    int32_t r;
    if (use_gso)
      r = send_udp_gso(fd, ring_data, ring_len, capacity, slot_size,
                       seq_off + row, ts_off + row, ssrc + row, dest, n_outs,
                       ops, n_ops);
    else
      r = send_udp_plain(fd, ring_data, ring_len, capacity, slot_size,
                         seq_off + row, ts_off + row, ssrc + row, dest,
                         n_outs, ops, n_ops);
    if (r < 0) return total > 0 ? static_cast<int32_t>(total) : r;
    total += r;
  }
  return static_cast<int32_t>(total);
}

// The 4-byte $-frame is affine in (length, channel) as the RTP header is
// in the rewrite params, so one render emits [frame | header] per packet
// and writev scatters it with the shared payload.  A short write tears at
// a byte, reported through *partial_bytes_out.
int32_t ed_stream_send(int fd, const uint8_t *ring_data,
                       const int32_t *ring_len, int32_t capacity,
                       int32_t slot_size, uint32_t seq_off, uint32_t ts_off,
                       uint32_t ssrc, int32_t channel, const int32_t *slots,
                       int32_t n_slots, int32_t *partial_bytes_out) {
  g_stop_errno = 0;
  if (partial_bytes_out) *partial_bytes_out = 0;
  if (n_slots <= 0) return 0;
  if (channel < 0 || channel > 255) return -EINVAL;
  StatTimer timer(g_stat.send_ns);
  constexpr int kStreamBatch = 256;  // 512 iovecs, below IOV_MAX
  std::vector<iovec> iovs(static_cast<size_t>(kStreamBatch) * 2);
  std::vector<iovec> window(static_cast<size_t>(kStreamBatch) * 2);
  std::vector<uint8_t> hdrs(static_cast<size_t>(kStreamBatch) * 16);
  std::vector<int32_t> plens(kStreamBatch);
  int32_t done = 0;
  while (done < n_slots) {
    int batch = 0;
    size_t batch_bytes = 0;
    for (; batch < kStreamBatch && done + batch < n_slots; ++batch) {
      const int32_t slot = slots[done + batch];
      if (slot < 0 || slot >= capacity) {
        g_stop_errno = EINVAL;
        return done > 0 ? done : -EINVAL;
      }
      const uint8_t *pkt = ring_data + static_cast<size_t>(slot) * slot_size;
      const int32_t len = ring_len[slot];
      if (len < 12 || len > slot_size || len > 0xFFFF) {
        g_stop_errno = EINVAL;
        return done > 0 ? done : -EINVAL;
      }
      uint8_t *h = hdrs.data() + static_cast<size_t>(batch) * 16;
      h[0] = 0x24;  // '$'
      h[1] = static_cast<uint8_t>(channel);
      h[2] = static_cast<uint8_t>(len >> 8);
      h[3] = static_cast<uint8_t>(len);
      render_header(h + 4, pkt, seq_off, ts_off, ssrc);
      iovec *iv = &iovs[static_cast<size_t>(batch) * 2];
      iv[0].iov_base = h;
      iv[0].iov_len = 16;
      iv[1].iov_base = const_cast<uint8_t *>(pkt) + 12;
      iv[1].iov_len = static_cast<size_t>(len - 12);
      plens[batch] = len + 4;
      batch_bytes += static_cast<size_t>(len) + 4;
    }
    size_t written = 0;
    for (;;) {
      const int ferr = fault_egress_gate();
      if (ferr) {
        g_stop_errno = ferr;
        stat_add(g_stat.stream_writev_calls, 1);
        note_send_stop(ferr);
        break;
      }
      // the iovec window from byte `written` on (rebuilt only after EINTR)
      size_t skip = written, first = 0;
      const size_t n_iov = static_cast<size_t>(batch) * 2;
      while (first < n_iov && skip >= iovs[first].iov_len)
        skip -= iovs[first++].iov_len;
      if (first >= n_iov) break;
      const size_t n_cur = n_iov - first;
      for (size_t i = 0; i < n_cur; ++i) window[i] = iovs[first + i];
      window[0].iov_base = static_cast<uint8_t *>(window[0].iov_base) + skip;
      window[0].iov_len -= skip;
      const ssize_t w = writev(fd, window.data(), static_cast<int>(n_cur));
      if (w < 0) {
        if (errno == EINTR) continue;
        g_stop_errno = errno;
        stat_add(g_stat.stream_writev_calls, 1);
        note_send_stop(g_stop_errno);
        break;
      }
      stat_add(g_stat.stream_writev_calls, 1);
      stat_add(g_stat.stream_bytes, w);
      written += static_cast<size_t>(w);
      if (written >= batch_bytes) break;
      // a short write on a non-blocking socket: the send buffer is full,
      // so stop with flow-control semantics rather than spin into EAGAIN
      g_stop_errno = EAGAIN;
      stat_add(g_stat.eagain_stops, 1);
      break;
    }
    int full = 0;
    size_t acc = 0;
    while (full < batch && acc + static_cast<size_t>(plens[full]) <= written)
      acc += static_cast<size_t>(plens[full++]);
    stat_add(g_stat.stream_packets, full);
    done += full;
    if (written < batch_bytes || g_stop_errno) {
      if (partial_bytes_out)
        *partial_bytes_out = static_cast<int32_t>(written - acc);
      if (done == 0 && written == 0 && g_stop_errno &&
          g_stop_errno != EAGAIN && g_stop_errno != EWOULDBLOCK)
        return -g_stop_errno;
      return done;
    }
  }
  return done;
}

int32_t ed_stage_gather(const uint8_t *ring_data, const int32_t *ring_len,
                        int32_t capacity, int32_t slot_size,
                        const int32_t *slots, int32_t n_slots,
                        int32_t prefix_width, uint8_t *out,
                        int32_t out_stride, int32_t out_rows) {
  if (n_slots < 0 || out_rows < n_slots || prefix_width <= 0 ||
      prefix_width > slot_size || out_stride < prefix_width + 4)
    return -EINVAL;
  for (int32_t i = 0; i < n_slots; ++i)
    if (slots[i] < 0 || slots[i] >= capacity) return -EINVAL;
  StatTimer timer(g_stat.stage_gather_ns);
  for (int32_t i = 0; i < n_slots; ++i) {
    uint8_t *row = out + static_cast<size_t>(i) * out_stride;
    // ring slots are zero past their length, so a full prefix copy never
    // carries an earlier packet's bytes
    std::memcpy(row, ring_data + static_cast<size_t>(slots[i]) * slot_size,
                static_cast<size_t>(prefix_width));
    const uint32_t len = static_cast<uint32_t>(ring_len[slots[i]]);
    row[prefix_width + 0] = static_cast<uint8_t>(len);
    row[prefix_width + 1] = static_cast<uint8_t>(len >> 8);
    row[prefix_width + 2] = static_cast<uint8_t>(len >> 16);
    row[prefix_width + 3] = static_cast<uint8_t>(len >> 24);
    if (out_stride > prefix_width + 4)
      std::memset(row + prefix_width + 4, 0,
                  static_cast<size_t>(out_stride - prefix_width - 4));
  }
  // the padding rows of a reused buffer must not carry an earlier wake
  if (out_rows > n_slots)
    std::memset(out + static_cast<size_t>(n_slots) * out_stride, 0,
                static_cast<size_t>(out_rows - n_slots) * out_stride);
  stat_add(g_stat.staged_bytes,
           static_cast<int64_t>(n_slots) * (prefix_width + 4));
  return n_slots;
}

int32_t ed_udp_ingest(int fd, uint8_t *ring_data, int32_t *ring_len,
                      int64_t *ring_arrival, int32_t capacity,
                      int32_t slot_size, int64_t now_ms, int64_t *head,
                      int32_t max_pkts, int32_t *oversize_dropped) {
  if (capacity <= 0 || slot_size <= 0 || max_pkts < 0 || *head < 0)
    return -EINVAL;
  StatTimer timer(g_stat.ingest_ns);
  int32_t admitted = 0;
  // what max_pkts bounds: datagrams consumed from the socket, dropped ones
  // included, so an oversize flood cannot stretch one call
  int32_t consumed = 0;
  mmsghdr msgs[kRecvBatch];
  iovec iovs[kRecvBatch];
  while (consumed < max_pkts) {
    const int want = std::min<int32_t>(kRecvBatch, max_pkts - consumed);
    for (int i = 0; i < want; ++i) {
      const int64_t slot = (*head + i) % capacity;
      iovs[i].iov_base = ring_data + slot * slot_size;
      iovs[i].iov_len = static_cast<size_t>(slot_size);
      std::memset(&msgs[i], 0, sizeof(mmsghdr));
      msgs[i].msg_hdr.msg_iov = &iovs[i];
      msgs[i].msg_hdr.msg_iovlen = 1;
    }
    const int n = recvmmsg(fd, msgs, want, MSG_DONTWAIT, nullptr);
    if (n < 0) {
      if (errno == EINTR) continue;
      if (errno == EAGAIN || errno == EWOULDBLOCK) break;
      // datagrams of earlier batches are consumed already: report them so
      // the caller commits the head
      return admitted > 0 ? admitted : -errno;
    }
    if (n == 0) break;
    stat_add(g_stat.recvmmsg_calls, 1);
    int wrote = 0;
    int64_t bytes = 0;
    for (int i = 0; i < n; ++i) {
      if (msgs[i].msg_hdr.msg_flags & MSG_TRUNC) {
        if (oversize_dropped) ++*oversize_dropped;
        stat_add(g_stat.oversize_dropped, 1);
        continue;
      }
      const int32_t len = static_cast<int32_t>(msgs[i].msg_len);
      const int64_t src = (*head + i) % capacity;
      const int64_t dst = (*head + wrote) % capacity;
      uint8_t *row = ring_data + dst * slot_size;
      if (dst != src)  // compact over a dropped datagram's slot
        std::memmove(row, ring_data + src * slot_size,
                     static_cast<size_t>(len));
      // slots are zero past their length (the upload gather relies on it)
      if (len < slot_size)
        std::memset(row + len, 0, static_cast<size_t>(slot_size - len));
      ring_len[dst] = len;
      ring_arrival[dst] = now_ms;
      bytes += len;
      ++wrote;
    }
    *head += wrote;
    admitted += wrote;
    consumed += n;
    stat_add(g_stat.recv_packets, wrote);
    stat_add(g_stat.recv_bytes, bytes);
    if (n < want) break;
  }
  return admitted;
}

}  // extern "C"

// ------------------------------------------------------ io_uring probe
//
// Raw syscalls and the kernel's frozen ABI layouts, defined here so that
// one source builds against any <linux/io_uring.h> vintage, or none.

namespace {

#ifndef __NR_io_uring_setup
#define __NR_io_uring_setup 425
#endif
#ifndef __NR_io_uring_register
#define __NR_io_uring_register 427
#endif

constexpr unsigned kProbeEntries = 8;
constexpr uint32_t kSetupSqpoll = 1u << 1;
constexpr uint32_t kSetupClamp = 1u << 4;
constexpr uint64_t kOffSqRing = 0;
constexpr unsigned kRegBuffers = 0;
constexpr unsigned kRegProbe = 8;
constexpr uint16_t kOpSupported = 1u << 0;
// opcodes (ABI-stable ids)
constexpr uint8_t kOpSendmsg = 9;
constexpr uint8_t kOpRecvmsg = 10;
constexpr uint8_t kOpSendZc = 26;
constexpr uint8_t kOpSendmsgZc = 30;
constexpr uint8_t kOpProvideBuffers = 31;

struct SqOffsets {
  uint32_t head, tail, ring_mask, ring_entries, flags, dropped, array, resv1;
  uint64_t user_addr;
};
struct CqOffsets {
  uint32_t head, tail, ring_mask, ring_entries, overflow, cqes, flags, resv1;
  uint64_t user_addr;
};
struct UringParams {
  uint32_t sq_entries, cq_entries, flags, sq_thread_cpu, sq_thread_idle,
      features, wq_fd, resv[3];
  SqOffsets sq_off;
  CqOffsets cq_off;
};
static_assert(sizeof(UringParams) == 120, "io_uring_params ABI");

struct ProbeOp {
  uint8_t op, resv;
  uint16_t flags;
  uint32_t resv2;
};
struct Probe {
  uint8_t last_op, ops_len;
  uint16_t resv;
  uint32_t resv2[3];
  ProbeOp ops[256];
};

int uring_setup(unsigned entries, UringParams *p) {
  return static_cast<int>(syscall(__NR_io_uring_setup, entries, p));
}

int uring_register(int fd, unsigned opcode, const void *arg,
                   unsigned nr_args) {
  return static_cast<int>(
      syscall(__NR_io_uring_register, fd, opcode, arg, nr_args));
}

bool op_supported(const Probe &p, uint8_t op) {
  return op <= p.last_op && (p.ops[op].flags & kOpSupported);
}

}  // namespace

extern "C" {

int32_t ed_uring_probe(void) {
  UringParams params;
  std::memset(&params, 0, sizeof(params));
  params.flags = kSetupClamp;
  const int fd = uring_setup(kProbeEntries, &params);
  if (fd < 0) return -errno;  // ENOSYS, EPERM (seccomp, sysctl), EMFILE
  // map the submission ring as a ring user would
  const size_t sq_bytes =
      params.sq_off.array + params.sq_entries * sizeof(uint32_t);
  void *sq = mmap(nullptr, sq_bytes, PROT_READ | PROT_WRITE,
                  MAP_SHARED | MAP_POPULATE, fd, kOffSqRing);
  if (sq == MAP_FAILED) {
    const int err = errno;
    close(fd);
    return -err;
  }
  munmap(sq, sq_bytes);
  int32_t caps = ED_URING_CAP_RING;
  Probe probe;
  std::memset(&probe, 0, sizeof(probe));
  if (uring_register(fd, kRegProbe, &probe, 256) == 0) {
    if (!op_supported(probe, kOpSendmsg) ||
        !op_supported(probe, kOpRecvmsg)) {
      close(fd);
      return -ENOSYS;  // a ring without sendmsg/recvmsg is of no use here
    }
    if (op_supported(probe, kOpSendmsgZc)) caps |= ED_URING_CAP_SEND_ZC;
    // multishot recvmsg came with the zero-copy sends (6.0/6.1); no probe
    // exists for flags, so the ops of that release stand in for it
    if (op_supported(probe, kOpSendZc) &&
        op_supported(probe, kOpProvideBuffers))
      caps |= ED_URING_CAP_RECV_MULTI;
  }
  // a ring older than the op probe (5.6) has sendmsg/recvmsg (5.3) and
  // none of the newer ops
  alignas(4096) static uint8_t page[4096];
  iovec iov{page, sizeof(page)};
  if (uring_register(fd, kRegBuffers, &iov, 1) == 0)
    caps |= ED_URING_CAP_FIXED_BUFS;
  close(fd);
  // SQPOLL changes how the ring is built, so it needs a setup of its own
  UringParams sp;
  std::memset(&sp, 0, sizeof(sp));
  sp.flags = kSetupClamp | kSetupSqpoll;
  sp.sq_thread_idle = 50;
  const int sfd = uring_setup(kProbeEntries, &sp);
  if (sfd >= 0) {
    caps |= ED_URING_CAP_SQPOLL;
    close(sfd);
  }
  return caps;
}

}  // extern "C"

extern "C" {

/* ------------------------------------------------------------- timer wheel */

struct ed_wheel {
  // 1 ms hashed wheel: 4096 buckets; overflow handled by re-hashing rounds.
  static constexpr int kSlots = 4096;
  struct Entry {
    int64_t id;
    int64_t fire_ms;
    int64_t user_data;
  };
  std::vector<Entry> slots[kSlots];
  std::map<int64_t, int> where;  // id -> slot (for cancel)
  int64_t now_ms;
  int64_t next_id = 1;
  int32_t pending = 0;
};

ed_wheel *ed_wheel_new(int64_t now_ms) {
  auto *w = new ed_wheel();
  w->now_ms = now_ms;
  return w;
}

void ed_wheel_free(ed_wheel *w) { delete w; }

int64_t ed_wheel_schedule(ed_wheel *w, int64_t delay_ms, int64_t user_data) {
  if (delay_ms < 0) delay_ms = 0;
  int64_t fire = w->now_ms + delay_ms;
  int slot = static_cast<int>(fire % ed_wheel::kSlots);
  int64_t id = w->next_id++;
  w->slots[slot].push_back({id, fire, user_data});
  w->where[id] = slot;
  w->pending++;
  return id;
}

int ed_wheel_cancel(ed_wheel *w, int64_t timer_id) {
  auto it = w->where.find(timer_id);
  if (it == w->where.end()) return 0;
  auto &vec = w->slots[it->second];
  for (auto e = vec.begin(); e != vec.end(); ++e) {
    if (e->id == timer_id) {
      vec.erase(e);
      w->where.erase(it);
      w->pending--;
      return 1;
    }
  }
  w->where.erase(it);
  return 0;
}

int32_t ed_wheel_advance(ed_wheel *w, int64_t now_ms, int64_t *out,
                         int32_t max_out) {
  int32_t fired = 0;
  if (now_ms <= w->now_ms) return 0;
  // bound the walk: never more than one full wheel revolution
  int64_t steps = now_ms - w->now_ms;
  if (steps > ed_wheel::kSlots) steps = ed_wheel::kSlots;
  for (int64_t t = 0; t < steps && fired < max_out; ++t) {
    int64_t tick = w->now_ms + 1 + t;
    auto &vec = w->slots[tick % ed_wheel::kSlots];
    for (size_t i = 0; i < vec.size() && fired < max_out;) {
      if (vec[i].fire_ms <= now_ms) {
        out[fired++] = vec[i].user_data;
        w->where.erase(vec[i].id);
        vec[i] = vec.back();
        vec.pop_back();
        w->pending--;
      } else {
        ++i;
      }
    }
  }
  w->now_ms = now_ms;
  return fired;
}

int64_t ed_wheel_next(const ed_wheel *w, int64_t now_ms) {
  int64_t best = -1;
  for (int s = 0; s < ed_wheel::kSlots; ++s) {
    for (const auto &e : w->slots[s]) {
      int64_t d = e.fire_ms - now_ms;
      if (d < 0) d = 0;
      if (best < 0 || d < best) best = d;
    }
  }
  if (best > 3600000) best = 3600000;
  return best;
}

int32_t ed_wheel_pending(const ed_wheel *w) { return w->pending; }

}  // extern "C"
