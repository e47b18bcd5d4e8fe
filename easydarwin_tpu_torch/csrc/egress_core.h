/* egress_core — the host egress data plane of easydarwin_tpu_torch.
 *
 * Plain C interface, bound with ctypes by easydarwin_tpu_torch/native.py,
 * built there with g++ -O3 -fPIC -shared -std=c++17 at first use.  It
 * sends what the relay engine computed: every UDP player of a stream in
 * one sendmmsg (or UDP-GSO) scatter with the 12-byte RTP header rewritten
 * on the fly from per-subscriber affine params, every interleaved TCP
 * player in one framed writev, and packs the megabatch scheduler's upload
 * rows; on ingest it drains a UDP pusher's RTP socket in recvmmsg batches
 * straight into the packet ring.  No Python runs per packet, and payload
 * bytes are never copied per subscriber.
 */
#ifndef EASYDARWIN_TPU_TORCH_EGRESS_CORE_H
#define EASYDARWIN_TPU_TORCH_EGRESS_CORE_H

#include <stddef.h>
#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

/* Why the calling thread's last send entry point stopped short: 0 =
 * completed, EAGAIN/EWOULDBLOCK = flow control (keep bookmarks, replay),
 * anything else = a hard per-datagram error (skip past it, as the scalar
 * relay does on WriteResult.ERROR).  Thread-local. */
int32_t ed_last_send_errno(void);

/* Process-wide cumulative counters, relaxed atomics.  Every field is
 * int64; ed_stats_fields() is the count the Python bridge checks at load. */
typedef struct {
  int64_t sendmmsg_calls;      /* sendmmsg(2) calls (plain and GSO) */
  int64_t send_packets;        /* datagrams handed to the kernel */
  int64_t gso_supers;          /* multi-segment UDP_SEGMENT sends */
  int64_t gso_segments;        /* segments inside those sends */
  int64_t eagain_stops;        /* sends stopped by EAGAIN/EWOULDBLOCK */
  int64_t hard_errors;         /* sends stopped by a hard errno */
  int64_t bytes_to_wire;       /* datagram bytes handed to the kernel */
  int64_t send_ns;             /* ns inside the send entry points */
  int64_t stage_gather_ns;     /* ns inside ed_stage_gather */
  int64_t staged_bytes;        /* prefix + length bytes packed */
  int64_t fault_injections;    /* injected EAGAIN/ENOBUFS/latency events */
  int64_t stream_writev_calls; /* writev(2)/send(2) calls on stream fds */
  int64_t stream_packets;      /* framed packets fully written */
  int64_t stream_bytes;        /* bytes written to stream sockets */
  int64_t recvmmsg_calls;      /* recvmmsg(2) calls that returned data */
  int64_t recv_packets;        /* datagrams admitted into a ring */
  int64_t recv_bytes;          /* bytes of those datagrams */
  int64_t oversize_dropped;    /* kernel-truncated datagrams dropped */
  int64_t ingest_ns;           /* ns inside ed_udp_ingest */
} ed_stats;

void ed_get_stats(ed_stats *out);
void ed_reset_stats(void);
int32_t ed_stats_fields(void);

/* Deterministic egress faults: every eagain_every-th send call stops with
 * EAGAIN before its syscall, every enobufs_every-th with ENOBUFS, every
 * latency_every-th sleeps latency_us first.  0 disables a knob; setting
 * restarts the counters, so one setting is one schedule. */
void ed_fault_set(int64_t eagain_every, int64_t enobufs_every,
                  int64_t latency_every, int64_t latency_us);
void ed_fault_clear(void);

/* One send op: ring slot -> subscriber index. */
typedef struct {
  int32_t slot;
  int32_t out;
} ed_sendop;

/* A destination: network-order IPv4 address and port. */
typedef struct {
  uint32_t ip_be;
  uint16_t port_be;
  uint16_t _pad;
} ed_dest;

/* UDP fan-out with the affine header rewrite (seq += seq_off mod 2^16,
 * ts += ts_off, ssrc = ssrc[out], bytes 0-1 kept): each op sends
 * [header | packet[12:len]] as two iovecs through sendmmsg (use_gso 0), or
 * with runs of same-subscriber, same-size ops coalesced into UDP_SEGMENT
 * (GSO) super-datagrams (use_gso 1).  n_src sources share the ring and the
 * op list; params are [n_src, param_stride] row-major.  Returns the ops
 * sent: EAGAIN stops early with the count so far; a hard error returns the
 * count delivered, or -errno if none was (-EINVAL or -EOPNOTSUPP from the
 * GSO rung with nothing sent means the kernel has no UDP GSO). */
int32_t ed_fanout_send_multi(int fd, const uint8_t *ring_data,
                             const int32_t *ring_len, int32_t capacity,
                             int32_t slot_size, const uint32_t *seq_off,
                             const uint32_t *ts_off, const uint32_t *ssrc,
                             int32_t n_src, int32_t param_stride,
                             const ed_dest *dest, int32_t n_outs,
                             const ed_sendop *ops, int32_t n_ops,
                             int32_t use_gso);

/* Interleaved RTSP egress onto one stream socket: per slot the frame
 * ($ | channel | be16 length) and the rewritten header, then the payload,
 * through writev.  Returns packets fully written; *partial_bytes_out is
 * how many bytes of the next packet a short write already put on the wire
 * (the caller must send the rest before anything else).  -errno only when
 * nothing was written and the stop was hard. */
int32_t ed_stream_send(int fd, const uint8_t *ring_data,
                       const int32_t *ring_len, int32_t capacity,
                       int32_t slot_size, uint32_t seq_off, uint32_t ts_off,
                       uint32_t ssrc, int32_t channel, const int32_t *slots,
                       int32_t n_slots, int32_t *partial_bytes_out);

/* The megabatch upload gather: row i of out receives the first
 * prefix_width bytes of slot slots[i] and its length as le32, the rest of
 * the row zero; rows [n_slots, out_rows) are zeroed.  Returns n_slots or
 * -EINVAL. */
int32_t ed_stage_gather(const uint8_t *ring_data, const int32_t *ring_len,
                        int32_t capacity, int32_t slot_size,
                        const int32_t *slots, int32_t n_slots,
                        int32_t prefix_width, uint8_t *out,
                        int32_t out_stride, int32_t out_rows);

/* Drain up to max_pkts datagrams from fd (non-blocking recvmmsg, at most
 * 64 a call) straight into ring rows [capacity, slot_size] from *head (mod
 * capacity), writing each length and arrival_ms (now_ms) and zeroing the
 * row past the datagram.  A kernel-truncated datagram (MSG_TRUNC: larger
 * than the slot) is dropped, compacted over and counted in
 * *oversize_dropped (nullable): a truncated slot would relay a corrupt
 * packet.  max_pkts bounds the datagrams consumed, dropped ones included.
 * Returns the datagrams admitted (0 if none) and advances *head by as
 * many, or -errno on a hard error with nothing admitted. */
int32_t ed_udp_ingest(int fd, uint8_t *ring_data, int32_t *ring_len,
                      int64_t *ring_arrival, int32_t capacity,
                      int32_t slot_size, int64_t now_ms, int64_t *head,
                      int32_t max_pkts, int32_t *oversize_dropped);

/* What io_uring offers this process, from raw syscalls (no liburing): one
 * throwaway ring answers every capability question.  Returns the
 * ED_URING_CAP_* bits (>= 0), or -errno when there is no usable ring
 * (ENOSYS: no io_uring, or no sendmsg/recvmsg on it; EPERM: a seccomp or
 * sysctl denial). */
#define ED_URING_CAP_RING        1   /* io_uring_setup + mmap worked */
#define ED_URING_CAP_SQPOLL      2   /* kernel-side submission polling */
#define ED_URING_CAP_SEND_ZC     4   /* IORING_OP_SENDMSG_ZC */
#define ED_URING_CAP_RECV_MULTI  8   /* multishot recvmsg ingest */
#define ED_URING_CAP_FIXED_BUFS 16   /* IORING_REGISTER_BUFFERS allowed
                                      * under this RLIMIT_MEMLOCK */
int32_t ed_uring_probe(void);

/* ------------------------------------------------------------ timer wheel */

/* Hashed timer wheel, 1 ms ticks: the pump's sleep until the earliest
 * stream deadline (a bucket-delay release, a reliable-UDP resend).
 * Single-threaded use from the owner loop.  A copy of the reference's
 * ed_wheel (csrc/edtpu_core.cpp). */
typedef struct ed_wheel ed_wheel;

ed_wheel *ed_wheel_new(int64_t now_ms);
void ed_wheel_free(ed_wheel *w);
/* schedule returns a timer id (>0) firing at now+delay_ms */
int64_t ed_wheel_schedule(ed_wheel *w, int64_t delay_ms, int64_t user_data);
int ed_wheel_cancel(ed_wheel *w, int64_t timer_id);
/* advance to now_ms; expired user_data values are copied into out (up to
 * max_out); returns number expired */
int32_t ed_wheel_advance(ed_wheel *w, int64_t now_ms, int64_t *out,
                         int32_t max_out);
/* ms until next timer from now_ms, or -1 if none (capped at 3600000) */
int64_t ed_wheel_next(const ed_wheel *w, int64_t now_ms);
int32_t ed_wheel_pending(const ed_wheel *w);

#ifdef __cplusplus
}
#endif

#endif
