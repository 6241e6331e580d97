// phaserotate_tpu.so — loadable LV2 plugin shim bridging to the GPU engine.
//
// The reference ships its DSP as a host-loadable binary
// (src/phaserotate.c:860-893); a GPU engine cannot run inside the host's
// process, so this shim implements the same LV2 ABI surface and forwards
// audio over the engine daemon's Unix socket (phaserotate_tpu/bridge.py
// documents the wire protocol; native/prt_protocol.h is the shared
// native framing).  Without a reachable daemon the plugin degrades to a
// clean bypass with zero reported latency — and keeps retrying the
// connection every ~kRetryRuns run() calls, so starting the daemon after
// the session loads (or restarting it) picks the plugin back up without
// reloading.
//
// Port map matches plugin/descriptors.py (and the reference's TTL):
//   0 control (atom in)             1 notify (atom out)
//   2 latency (control out)
//   3+3c angle (control in, deg)    4+3c audio in    5+3c audio out
//
// The atom ports are live when the host supplies urid:map: control-port
// objects (ui_on / ui_off / reset_peaks / state — the reference's GUI
// vocabulary, src/phaserotate.c:795-830) are forwarded to the daemon as
// CTRL wire messages, and the daemon's LEVELS/STATE stream comes back as
// real 'levels'/'state' atoms on the notify port (src/phaserotate.c:
// 741-771, 522-536) — so a host GUI sees the reference's exact protocol
// across the process boundary.
//
// The socket round trip makes run() block on the engine; this shim
// targets offline/freewheel rendering and tolerant hosts rather than the
// reference's hardRTCapable contract (that lives in the daemon's own
// engine scheduling).

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <new>
#include <vector>

#include "lv2_abi.h"
#include "prt_atom.h"
#include "prt_protocol.h"

namespace {

constexpr const char* kUriMono = "urn:phaserotate-tpu:plugin";
constexpr const char* kUriStereo = "urn:phaserotate-tpu:plugin#stereo";
constexpr uint32_t kRetryRuns = 256;  // reconnect attempt cadence

struct Plugin {
  uint32_t channels = 1;
  double rate = 48000.0;
  prt::Conn conn;
  uint32_t latency = 0;
  uint32_t runs_since_retry = 0;

  float* latency_port = nullptr;
  float* angle[2] = {nullptr, nullptr};
  float* in[2] = {nullptr, nullptr};
  float* out[2] = {nullptr, nullptr};

  // atom ports (live only when the host mapped our URIDs)
  prt::ProtUrids urids;
  const void* control = nullptr;  // host-filled sequence, read in run()
  void* notify = nullptr;         // plugin-forged sequence
  std::vector<uint8_t> pending_levels;  // kLevels payloads this block
  bool have_state = false;
  float state_uiscale = 1.0f;
  uint32_t state_link = 0;

  std::vector<uint8_t> msg;
  std::vector<uint8_t> reply;

  const char* socket_path() const {
    const char* path = getenv("PHASEROTATE_TPU_SOCKET");
    return (path && *path) ? path : "/tmp/phaserotate_tpu.sock";
  }

  void try_connect() {
    runs_since_retry = 0;
    if (!conn.open(socket_path(), static_cast<uint32_t>(rate), channels,
                   &latency)) {
      latency = 0;
    }
  }

  void bypass(uint32_t n) {
    for (uint32_t c = 0; c < channels; ++c)
      if (in[c] && out[c] && in[c] != out[c])
        memcpy(out[c], in[c], n * sizeof(float));
  }

  // Forward the block's control-port objects as CTRL wire messages —
  // the reference's atom dispatch (src/phaserotate.c:800-830) mapped
  // onto the daemon protocol.  Fire-and-forget: no replies to await.
  void send_ctrl_events() {
    if (!control || !urids.ok || conn.fd < 0) return;
    prt::each_object(control, urids, [&](const prt::AtomObjectView& o) {
      uint32_t ev = 0;
      if (o.otype == urids.ui_on) ev = prt::kCtrlUiOn;
      else if (o.otype == urids.ui_off) ev = prt::kCtrlUiOff;
      else if (o.otype == urids.reset_peaks) ev = prt::kCtrlResetPeaks;
      else if (o.otype == urids.state) {
        struct {
          uint32_t ev;
          float uiscale;
          uint32_t link;
        } m = {prt::kCtrlState, 1.0f, 0};
        o.get_f32(urids.s_uiscale, &m.uiscale);
        int32_t l = 0;
        o.get_i32(urids.s_link, &l);
        m.link = l ? 1u : 0u;
        conn.send_msg(prt::kCtrl, &m, sizeof m);
        return;
      }
      if (ev) conn.send_msg(prt::kCtrl, &ev, sizeof ev);
    });
  }

  // Host contract: before run() the host sets the notify buffer's atom
  // size to its capacity (as an atom:Chunk); the plugin replaces it
  // with a Sequence.  Captured ONCE per run() before any sequence is
  // written — the first write overwrites the very header that carried
  // the capacity.
  uint32_t notify_cap = 0;

  void capture_notify_capacity() {
    notify_cap = reinterpret_cast<const prt::Atom*>(notify)->size +
                 sizeof(prt::Atom);
  }

  // Forge the LEVELS/STATE stream collected during this block's PROC
  // round trip into real notify atoms (the reference's 'levels' and
  // 'state' objects, src/phaserotate.c:741-771, 522-536).
  void forge_notify() {
    if (!notify || !urids.ok) return;
    prt::AtomForge f;
    f.begin_sequence(notify, notify_cap, urids);
    constexpr size_t kEntry = 40;  // u32 channel + 9 f32
    for (size_t o = 0; o + kEntry <= pending_levels.size();
         o += kEntry) {
      uint32_t chn;
      float v[9];
      memcpy(&chn, pending_levels.data() + o, 4);
      memcpy(v, pending_levels.data() + o + 4, 36);
      f.open_object(urids, urids.levels);
      f.prop_int(urids, urids.l_channel, static_cast<int32_t>(chn));
      const uint32_t keys[9] = {
          urids.l_in_cur,   urids.l_in_mom,   urids.l_in_peak,
          urids.l_out_cur,  urids.l_out_mom,  urids.l_out_peak,
          urids.l_diff_cur, urids.l_diff_min, urids.l_diff_max};
      for (int k = 0; k < 9; ++k) f.prop_float(urids, keys[k], v[k]);
      f.close_object();
    }
    pending_levels.clear();
    if (have_state) {
      f.open_object(urids, urids.state);
      f.prop_float(urids, urids.s_uiscale, state_uiscale);
      f.prop_bool(urids, urids.s_link, state_link != 0);
      f.close_object();
      have_state = false;
    }
  }

  void run(uint32_t n) {
    if (conn.fd < 0 && ++runs_since_retry >= kRetryRuns)
      try_connect();  // daemon may have (re)started since
    if (latency_port) *latency_port = static_cast<float>(latency);
    if (notify && urids.ok) {  // always leave a valid (possibly empty)
      capture_notify_capacity();
      prt::empty_sequence(notify, notify_cap, urids);
    }
    if (conn.fd < 0) {
      bypass(n);
      return;
    }
    send_ctrl_events();
    msg.assign(4 + 4 * channels + 4 * n * channels, 0);
    uint32_t* h = reinterpret_cast<uint32_t*>(msg.data());
    h[0] = n;
    float* body = reinterpret_cast<float*>(msg.data() + 4);
    for (uint32_t c = 0; c < channels; ++c)
      body[c] = angle[c] ? *angle[c] : 0.0f;
    for (uint32_t i = 0; i < n; ++i)
      for (uint32_t c = 0; c < channels; ++c)
        body[channels + i * channels + c] = in[c] ? in[c][i] : 0.0f;
    uint32_t rtype;
    // collect info messages only when they can be forged somewhere —
    // with inert atom ports (no urid:map or notify unconnected) the
    // buffer would otherwise grow forever on a metering daemon
    const bool atoms_live = notify && urids.ok;
    auto on_info = [&](uint32_t type, const std::vector<uint8_t>& p) {
      if (!atoms_live) return;
      if (type == prt::kLevels && p.size() >= 4) {
        uint32_t count;
        memcpy(&count, p.data(), 4);
        size_t want = 4 + 40ull * count;
        if (p.size() >= want)
          pending_levels.insert(pending_levels.end(), p.begin() + 4,
                                p.begin() + want);
      } else if (type == prt::kState && p.size() >= 8) {
        memcpy(&state_uiscale, p.data(), 4);
        memcpy(&state_link, p.data() + 4, 4);
        have_state = true;
      }
    };
    if (!conn.send_msg(prt::kProc, msg.data(), msg.size()) ||
        !conn.recv_reply(&rtype, &reply, on_info) ||
        rtype != prt::kProcOk ||
        reply.size() < 4 + 4ull * n * channels) {
      conn.close_fd();
      latency = 0;
      if (latency_port) *latency_port = 0.0f;
      // drop half-collected meter data: forging it after a reconnect
      // would attribute a stale spike to unrelated audio
      pending_levels.clear();
      have_state = false;
      bypass(n);  // degrade this block; retry cadence applies after
      return;
    }
    const float* got = reinterpret_cast<float*>(reply.data() + 4);
    for (uint32_t i = 0; i < n; ++i)
      for (uint32_t c = 0; c < channels; ++c)
        if (out[c]) out[c][i] = got[i * channels + c];
    forge_notify();
  }
};

LV2_Handle instantiate(const LV2_Descriptor* desc, double rate,
                       const char*, const LV2_Feature* const* features) {
  Plugin* p = new (std::nothrow) Plugin();
  if (!p) return nullptr;
  p->channels = strcmp(desc->URI, kUriStereo) == 0 ? 2 : 1;
  p->rate = rate;
  // urid:map makes the atom ports live; without it they stay inert
  // (the reference hard-requires the feature, src/phaserotate.c:252-256
  // — this shim's audio path works regardless, so it only soft-uses it)
  for (const LV2_Feature* const* f = features; f && *f; ++f) {
    if (strcmp((*f)->URI, prt::kUridMapUri) == 0)
      p->urids.map_all(static_cast<const prt::UridMap*>((*f)->data));
  }
  p->try_connect();
  return p;
}

void connect_port(LV2_Handle h, uint32_t port, void* data) {
  Plugin* p = static_cast<Plugin*>(h);
  if (port == 0) {
    p->control = data;
    return;
  }
  if (port == 1) {
    p->notify = data;
    return;
  }
  if (port == 2) {
    p->latency_port = static_cast<float*>(data);
    return;
  }
  uint32_t c = (port - 3) / 3;
  if (c >= p->channels) return;
  switch ((port - 3) % 3) {
    case 0: p->angle[c] = static_cast<float*>(data); break;
    case 1: p->in[c] = static_cast<float*>(data); break;
    case 2: p->out[c] = static_cast<float*>(data); break;
  }
}

void activate(LV2_Handle h) {
  // a host (re)activating is the natural moment to retry the engine
  Plugin* p = static_cast<Plugin*>(h);
  if (p->conn.fd < 0) p->try_connect();
}

void run(LV2_Handle h, uint32_t n) { static_cast<Plugin*>(h)->run(n); }

void deactivate(LV2_Handle) {}

void cleanup(LV2_Handle h) {
  Plugin* p = static_cast<Plugin*>(h);
  p->conn.bye();
  delete p;
}

const void* extension_data(const char*) { return nullptr; }

const LV2_Descriptor kMono = {kUriMono,   instantiate, connect_port,
                              activate,   run,         deactivate,
                              cleanup,    extension_data};
const LV2_Descriptor kStereo = {kUriStereo, instantiate, connect_port,
                                activate,   run,         deactivate,
                                cleanup,    extension_data};

}  // namespace

extern "C" LV2_SYMBOL_EXPORT const LV2_Descriptor* lv2_descriptor(
    uint32_t index) {
  switch (index) {
    case 0: return &kMono;
    case 1: return &kStereo;
    default: return nullptr;
  }
}
