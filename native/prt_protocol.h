// Wire protocol shared by the native engine clients (prt_bridge,
// phaserotate_tpu.so).  The protocol is defined in
// phaserotate_tpu/bridge.py; this header is the single native-side copy
// of its constants and framing helpers.

#ifndef PRT_PROTOCOL_H
#define PRT_PROTOCOL_H

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

#include <sys/socket.h>
#include <sys/time.h>
#include <sys/un.h>
#include <unistd.h>

namespace prt {

// Socket deadline for connect/handshake/replies.  Without it a stalled
// daemon (or a full accept backlog) blocks the calling host forever —
// for the LV2 shim that means a frozen audio host instead of the
// documented bypass.  The default is generous because the daemon's
// first block on a cold device can take tens of seconds to compile; tune
// with PHASEROTATE_TPU_TIMEOUT_MS (0 disables).
inline long timeout_ms() {
  const char* e = getenv("PHASEROTATE_TPU_TIMEOUT_MS");
  if (!e || !*e) return 60000;
  long v = atol(e);
  return v < 0 ? 0 : v;
}

inline void set_socket_deadline_ms(int fd, long ms) {
  if (ms <= 0) return;
  timeval tv;
  tv.tv_sec = ms / 1000;
  tv.tv_usec = (ms % 1000) * 1000;
  // SO_SNDTIMEO also bounds connect() on Linux.
  setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof tv);
  setsockopt(fd, SOL_SOCKET, SO_SNDTIMEO, &tv, sizeof tv);
}

inline void set_socket_deadline(int fd) {
  set_socket_deadline_ms(fd, timeout_ms());
}

// INIT_OK can legitimately take minutes on a cold accelerator (the
// daemon compiles the engine for this session's geometry on first
// use), unlike streaming replies which arrive within a block period —
// so the handshake gets its own, much longer deadline.
inline long handshake_timeout_ms() {
  const char* e = getenv("PHASEROTATE_TPU_HANDSHAKE_TIMEOUT_MS");
  if (!e || !*e) {
    long base = timeout_ms();
    return base <= 0 ? 0 : (base < 300000 ? 300000 : base);
  }
  long v = atol(e);
  return v < 0 ? 0 : v;
}

constexpr uint32_t kMagic = 0x50525431;  // "PRT1"
constexpr uint32_t kInit = 1, kProc = 2, kBye = 3;
constexpr uint32_t kAnalyzeBegin = 4, kAnalyzeData = 5, kAnalyzeEnd = 6;
constexpr uint32_t kCtrl = 7;  // fire-and-forget GUI control event
constexpr uint32_t kInitOk = 101, kProcOk = 102, kLevels = 103,
                   kState = 104, kErr = 199;
// replies must sit OUTSIDE the informational skip range 103..198
constexpr uint32_t kAnalyzeOk = 201;
// informational message range: clients skip these while awaiting a reply
constexpr uint32_t kInfoFirst = 103, kInfoLast = 198;
// kCtrl event codes (the reference's four control atoms,
// src/phaserotate.c:800-830)
constexpr uint32_t kCtrlUiOn = 1, kCtrlUiOff = 2, kCtrlResetPeaks = 3,
                   kCtrlState = 4;

struct Conn {
  int fd = -1;

  bool send_exact(const void* p, size_t n) {
    const char* c = static_cast<const char*>(p);
    while (n) {
      ssize_t k = write(fd, c, n);
      if (k <= 0) return false;
      c += k;
      n -= k;
    }
    return true;
  }

  bool recv_exact(void* p, size_t n) {
    char* c = static_cast<char*>(p);
    while (n) {
      ssize_t k = read(fd, c, n);
      if (k <= 0) return false;
      c += k;
      n -= k;
    }
    return true;
  }

  bool send_msg(uint32_t type, const void* payload, uint32_t len) {
    uint32_t hdr[2] = {type, len};
    return send_exact(hdr, 8) && (len == 0 || send_exact(payload, len));
  }

  // Largest legitimate payload is a PROC_OK block (max block size x
  // max channels x f32 ~= 1 MB); 64 MB leaves generous headroom while
  // keeping a desynced/corrupt length field (up to 4 GB-1) from
  // driving a giant allocation inside the DAW process — the daemon
  // applies the same class of cap on its side (bridge.py _recv_msg).
  static constexpr uint32_t kMaxPayload = 64u << 20;

  bool recv_msg(uint32_t* type, std::vector<uint8_t>* payload) {
    uint32_t hdr[2];
    if (!recv_exact(hdr, 8)) return false;
    if (hdr[1] > kMaxPayload) return false;  // stream is garbage: bail
    *type = hdr[0];
    payload->resize(hdr[1]);
    return hdr[1] == 0 || recv_exact(payload->data(), hdr[1]);
  }

  // Receive until a non-informational message arrives; info messages
  // (levels etc.) are passed to `on_info` when non-null, else dropped.
  template <typename F>
  bool recv_reply(uint32_t* type, std::vector<uint8_t>* payload,
                  F&& on_info) {
    while (true) {
      if (!recv_msg(type, payload)) return false;
      if (*type >= kInfoFirst && *type <= kInfoLast) {
        on_info(*type, *payload);
        continue;
      }
      return true;
    }
  }

  bool recv_reply(uint32_t* type, std::vector<uint8_t>* payload) {
    return recv_reply(type, payload,
                      [](uint32_t, const std::vector<uint8_t>&) {});
  }

  // Connect + magic only (no INIT): for analyze-only clients that
  // never instantiate a streaming session.
  bool open_raw(const char* path) {
    fd = socket(AF_UNIX, SOCK_STREAM, 0);
    if (fd < 0) return false;
    set_socket_deadline(fd);
    sockaddr_un addr{};
    addr.sun_family = AF_UNIX;
    snprintf(addr.sun_path, sizeof addr.sun_path, "%s", path);
    if (connect(fd, reinterpret_cast<sockaddr*>(&addr), sizeof addr) ||
        !send_exact(&kMagic, 4)) {
      close_fd();
      return false;
    }
    return true;
  }

  // Connect + handshake (magic, INIT, INIT_OK).  Returns false (fd=-1)
  // on any failure.  `latency_out` receives the engine latency.
  //
  // `wait_for_compile` selects the INIT_OK deadline: batch/offline
  // clients (prt_bridge) pass true and ride out a cold accelerator's
  // minutes-long engine compile; the LV2 shim passes false because
  // try_connect() runs on the AUDIO THREAD — it must fail fast into
  // bypass and retry on its run() cadence, by which time the daemon
  // has finished compiling and INIT_OK is immediate.
  bool open(const char* path, uint32_t rate, uint32_t channels,
            uint32_t* latency_out, bool wait_for_compile = false) {
    if (!open_raw(path)) return false;
    uint32_t init[2] = {rate, channels};
    uint32_t type;
    std::vector<uint8_t> reply;
    if (wait_for_compile)
      set_socket_deadline_ms(fd, handshake_timeout_ms());
    bool ok = send_msg(kInit, init, 8) &&
              recv_reply(&type, &reply) && type == kInitOk &&
              reply.size() >= 12;
    if (wait_for_compile)
      set_socket_deadline(fd);  // streaming: tight deadline again
    if (!ok) {
      close_fd();
      return false;
    }
    if (latency_out) memcpy(latency_out, reply.data(), 4);
    return true;
  }

  void close_fd() {
    if (fd >= 0) close(fd);
    fd = -1;
  }

  void bye() {
    if (fd >= 0) {
      send_msg(kBye, nullptr, 0);
      close_fd();
    }
  }
};

}  // namespace prt

#endif  // PRT_PROTOCOL_H
