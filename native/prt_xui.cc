// prt_xui.so — embedded in-process LV2UI (X11, software-rendered).
//
// The reference ships an embedded OpenGL LV2UI rendered inside the DAW
// (gui/phaserotate.c:1136-1309 via robtk/pugl).  This is the framework's
// in-process equivalent: a ui:X11UI that renders dials and meters into a
// plain ARGB framebuffer and blits it with XPutImage — no GL, no
// toolkit.  Widget semantics replicate the Python models exactly:
//
//   * dial: -180..180, 0.5-degree steps, detent at 0, 360-degree wrap,
//     scroll x10 (gui/widgets.py DialModel; gui/phaserotate.c:924-947)
//   * LINK: dial 1 mirrors dial 0 and goes insensitive
//     (gui/widgets.py LinkGroup; gui/phaserotate.c:846-874)
//   * meters: -80..+6.02 dBFS deflection over 86 dB, delta +-12 dB over
//     24 dB (gui/deflect.py; gui/phaserotate.c:220-254); gradient bar
//     with momentary cap + peak hold, bidirectional delta bar
//     (gui/phaserotate.c:534-727); click-on-meter sends reset_peaks
//     (gui/phaserotate.c:876-890)
//   * protocol: ui_on at instantiate / ui_off at cleanup
//     (gui/phaserotate.c:1099-1127); 'levels'/'state' notify atoms in,
//     angle control-port floats + control atoms out — the same atom
//     vocabulary as the reference (src/phaserotate.h:41-93), carried by
//     prt_atom.h.
//
// Xlib is loaded with dlopen at runtime (the build environment has no X
// headers or libraries; the Xlib C ABI is a frozen public interface, so
// the handful of functions and event layouts used are declared here from
// the specification).  Without a display — or with PHASEROTATE_TPU_XUI
// set to "headless" — the identical framebuffer + input pipeline runs
// detached from X; the prt_xui_test_* exports drive it (pointer
// injection + pixel reads), which is how tests/test_xui.py exercises the
// full widget logic without a screen.

#include <cmath>
#include <cstdint>
#include <initializer_list>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <new>

#include <dlfcn.h>

#include "prt_atom.h"

// ---------------------------------------------------------------------------
// LV2UI ABI (lv2plug.in/ns/extensions/ui, ISC spec — independent
// declaration, same rationale as lv2_abi.h)
// ---------------------------------------------------------------------------

extern "C" {

typedef void* LV2UI_Handle;
typedef void* LV2UI_Widget;
typedef void* LV2UI_Controller;
typedef void (*LV2UI_Write_Function)(LV2UI_Controller controller,
                                     uint32_t port_index,
                                     uint32_t buffer_size,
                                     uint32_t port_protocol,
                                     const void* buffer);

typedef struct {
  const char* URI;
  void* data;
} LV2_Feature_;

typedef struct LV2UI_Descriptor {
  const char* URI;
  LV2UI_Handle (*instantiate)(const struct LV2UI_Descriptor* descriptor,
                              const char* plugin_uri,
                              const char* bundle_path,
                              LV2UI_Write_Function write_function,
                              LV2UI_Controller controller,
                              LV2UI_Widget* widget,
                              const LV2_Feature_* const* features);
  void (*cleanup)(LV2UI_Handle ui);
  void (*port_event)(LV2UI_Handle ui, uint32_t port_index,
                     uint32_t buffer_size, uint32_t format,
                     const void* buffer);
  const void* (*extension_data)(const char* uri);
} LV2UI_Descriptor;

typedef struct {
  int (*idle)(LV2UI_Handle ui);
} LV2UI_Idle_Interface;

typedef struct {
  int (*show)(LV2UI_Handle ui);
  int (*hide)(LV2UI_Handle ui);
} LV2UI_Show_Interface;

// ui:resize feature (host-provided): the UI reports its size
typedef struct {
  void* handle;
  int (*ui_resize)(void* handle, int width, int height);
} LV2UI_Resize;

}  // extern "C"

// ---------------------------------------------------------------------------
// Minimal Xlib ABI via dlopen (X11 C ABI is frozen; declarations from
// the public spec)
// ---------------------------------------------------------------------------

namespace x11 {

typedef void Display;
typedef unsigned long Window;
typedef unsigned long Pixmap;
typedef void* GC;
typedef void XImageOpaque;  // created by XCreateImage, used opaquely

struct XEventPad {
  long pad[24];  // sizeof(XEvent): union padded to 24 longs
};

// the common prefix of X input/expose events (64-bit layout)
struct XAnyishEvent {
  int type;
  unsigned long serial;
  int send_event;
  Display* display;
  Window window;
  Window root;
  Window subwindow;
  unsigned long time;
  int x, y;
  int x_root, y_root;
  unsigned int state;
  unsigned int button;  // button for Button*, keycode for Key*
  int same_screen;
};

constexpr int kButtonPress = 4, kButtonRelease = 5, kMotionNotify = 6,
              kExpose = 12;
constexpr long kExposureMask = 1L << 15, kButtonPressMask = 1L << 2,
               kButtonReleaseMask = 1L << 3, kPointerMotionMask = 1L << 6,
               kButtonMotionMask = 1L << 13,
               kStructureNotifyMask = 1L << 17;

struct Api {
  void* lib = nullptr;
  int (*XInitThreads)();
  Display* (*XOpenDisplay)(const char*);
  int (*XCloseDisplay)(Display*);
  int (*XDefaultScreen)(Display*);
  Window (*XDefaultRootWindow)(Display*);
  void* (*XDefaultVisual)(Display*, int);
  int (*XDefaultDepth)(Display*, int);
  Window (*XCreateSimpleWindow)(Display*, Window, int, int, unsigned,
                                unsigned, unsigned, unsigned long,
                                unsigned long);
  GC (*XCreateGC)(Display*, Window, unsigned long, void*);
  int (*XFreeGC)(Display*, GC);
  int (*XSelectInput)(Display*, Window, long);
  int (*XMapWindow)(Display*, Window);
  int (*XUnmapWindow)(Display*, Window);
  int (*XStoreName)(Display*, Window, const char*);
  int (*XDestroyWindow)(Display*, Window);
  int (*XPending)(Display*);
  int (*XNextEvent)(Display*, XEventPad*);
  int (*XFlush)(Display*);
  XImageOpaque* (*XCreateImage)(Display*, void* visual, unsigned depth,
                                int format, int offset, char* data,
                                unsigned width, unsigned height,
                                int bitmap_pad, int bytes_per_line);
  int (*XPutImage)(Display*, Window, GC, XImageOpaque*, int, int, int,
                   int, unsigned, unsigned);

  bool load() {
    if (lib) return true;
    lib = dlopen("libX11.so.6", RTLD_NOW | RTLD_LOCAL);
    if (!lib) lib = dlopen("libX11.so", RTLD_NOW | RTLD_LOCAL);
    if (!lib) return false;
    auto sym = [&](const char* n) { return dlsym(lib, n); };
#define PRT_X(fn) *reinterpret_cast<void**>(&fn) = sym(#fn)
    PRT_X(XInitThreads);
    PRT_X(XOpenDisplay);
    PRT_X(XCloseDisplay);
    PRT_X(XDefaultScreen);
    PRT_X(XDefaultRootWindow);
    PRT_X(XDefaultVisual);
    PRT_X(XDefaultDepth);
    PRT_X(XCreateSimpleWindow);
    PRT_X(XCreateGC);
    PRT_X(XFreeGC);
    PRT_X(XSelectInput);
    PRT_X(XMapWindow);
    PRT_X(XUnmapWindow);
    PRT_X(XStoreName);
    PRT_X(XDestroyWindow);
    PRT_X(XPending);
    PRT_X(XNextEvent);
    PRT_X(XFlush);
    PRT_X(XCreateImage);
    PRT_X(XPutImage);
#undef PRT_X
    return XOpenDisplay && XCreateSimpleWindow && XPutImage &&
           XCreateImage && XNextEvent;
  }
};

Api& api() {
  static Api a;
  return a;
}

}  // namespace x11

// ---------------------------------------------------------------------------
// UI implementation
// ---------------------------------------------------------------------------

namespace {

constexpr const char* kUiUri = "urn:phaserotate-tpu:plugin#x11_ui";
constexpr const char* kUriStereo = "urn:phaserotate-tpu:plugin#stereo";

// layout (logical pixels)
constexpr int kRowH = 132;       // one channel row
constexpr int kLinkRowH = 26;    // stereo link row
constexpr int kWinW = 448;
constexpr int kDialCx = 62, kDialCy = 58, kDialR = 42;
constexpr int kMeterX = 140, kMeterW = 288, kMeterH = 14;
constexpr int kMeterYIn = 18, kMeterYOut = 50, kMeterYDelta = 82;
constexpr int kReadoutY = 108;

// colors (ARGB) — the level-meter gradient zones of gui/render.py
// (green to -18 dBFS, yellow to -9, orange to -3, red above; the
// standard program-meter zones the reference's cairo gradient encodes,
// gui/phaserotate.c:256-330)
constexpr uint32_t kBg = 0xff101010, kPanel = 0xff1c1c1c,
                   kBarBg = 0xff222222, kGreen = 0xff22aa22,
                   kYellow = 0xffcccc22, kOrange = 0xffee8822,
                   kRed = 0xffee3333, kCap = 0xffeeeeee,
                   kHold = 0xffff4444, kDelta = 0xff2288cc,
                   kRing = 0xff3a3a3a, kPointer = 0xffe0e0e0,
                   kTick = 0xff707070, kText = 0xffd0d0d0,
                   kLinkOn = 0xff2288cc, kLinkOff = 0xff303030;

// deflection maps (gui/deflect.py; gui/phaserotate.c:220-254)
double deflect_meter(double w, double v) {
  if (v < 1e-4) return 0.0;   // < -80 dBFS
  if (v > 2.0) return w;      // > +6.02 dBFS
  return w * (20.0 * log10(v) + 80.0) / 86.0;
}

double deflect_delta(double w, double v) {
  if (v < 0.252) return 0.0;  // < -12 dB
  if (v > 3.98) return w;     // > +12 dB
  return w * (20.0 * log10(v) + 12.0) / 24.0;
}

uint32_t gradient_color(double frac_of_width) {
  // bar position -> dB on the -80..+6 scale -> zone color
  double db = frac_of_width * 86.0 - 80.0;
  if (db <= -18.0) return kGreen;
  if (db <= -9.0) return kYellow;
  if (db <= -3.0) return kOrange;
  return kRed;
}

// 3x5 glyphs for the angle readout: 0-9 - . (rows top to bottom)
struct Glyph {
  char ch;
  uint8_t rows[5];  // 3 LSBs per row
};
constexpr Glyph kFont[] = {
    {'0', {7, 5, 5, 5, 7}}, {'1', {2, 6, 2, 2, 7}},
    {'2', {7, 1, 7, 4, 7}}, {'3', {7, 1, 7, 1, 7}},
    {'4', {5, 5, 7, 1, 1}}, {'5', {7, 4, 7, 1, 7}},
    {'6', {7, 4, 7, 5, 7}}, {'7', {7, 1, 1, 2, 2}},
    {'8', {7, 5, 7, 5, 7}}, {'9', {7, 5, 7, 1, 7}},
    {'-', {0, 0, 7, 0, 0}}, {'.', {0, 0, 0, 0, 2}},
};

// dial model — gui/widgets.py DialModel semantics, exactly
struct Dial {
  float value = 0.0f;
  bool sensitive = true;
  static constexpr float kMin = -180.0f, kMax = 180.0f, kStep = 0.5f,
                         kDefault = 0.0f, kScrollMult = 10.0f;

  // returns true when the value changed (caller notifies)
  bool set_value(float v) {
    if (!sensitive) return false;
    // Host control ports can carry anything (a DAW bug, a corrupt
    // session file): NaN/inf would poison the state and a huge finite
    // value would spin an iterative wrap for ~1e35 steps, so reject
    // non-finite and wrap in O(1) with fmod instead of a loop.
    if (!std::isfinite(v)) return false;
    // wrap FIRST: fmodf is exact, so a huge finite value (3.4e38)
    // reduces safely, whereas quantizing first overflows v/kStep to
    // inf and the wrap then yields NaN.  Wrap and quantize commute on
    // the value grid (the span is a multiple of the step).
    const float span = kMax - kMin;  // threesixty wrap
    const bool from_above = v > kMax;
    if (v > kMax || v < kMin) {
      v = fmodf(v - kMin, span);
      if (v < 0) v += span;
      v += kMin;
      // wrapping down from above lands on kMax, never on the
      // equivalent kMin (matches the iterative definition)
      if (v == kMin && from_above) v = kMax;
    }
    if (fabsf(v - kDefault) < kStep) v = kDefault;  // detent snap
    v = roundf(v / kStep) * kStep;                  // quantize
    // re-apply the seam rule after quantizing: an off-grid value just
    // above kMax (180.2) wraps to -179.8 and quantizes to kMin, but it
    // came from above, so it must display kMax (gui/widgets.py parity)
    if (v == kMin && from_above) v = kMax;
    if (v == value) return false;
    value = v;
    return true;
  }

  bool scroll(int steps) {
    return set_value(value + steps * kStep * kScrollMult);
  }
};

struct Meter {
  float in_cur = 0, in_mom = 0, in_peak = 0;
  float out_cur = 0, out_mom = 0, out_peak = 0;
  float diff_cur = 1, diff_min = 1, diff_max = 1;
};

struct Ui {
  uint32_t channels = 1;
  LV2UI_Write_Function write = nullptr;
  LV2UI_Controller controller = nullptr;
  prt::ProtUrids urids;
  float uiscale = 1.0f;

  Dial dial[2];
  Meter meter[2];
  bool link = false;

  int width = kWinW, height = kRowH;
  uint32_t* fb = nullptr;
  bool dirty = true;

  // drag state
  int drag_chn = -1;
  int drag_y0 = 0;
  float drag_v0 = 0;

  // X11 (absent in headless mode)
  bool headless = true;
  x11::Display* dpy = nullptr;
  x11::Window win = 0;
  x11::GC gc = nullptr;
  x11::XImageOpaque* img = nullptr;
  bool mapped = false;

  // -- atoms out ---------------------------------------------------------

  void send_object(uint32_t otype, bool with_state) {
    if (!write || !urids.ok) return;
    // one Object atom, written to the control port with eventTransfer
    // (the host wraps it into the plugin's control sequence)
    uint8_t buf[96];
    prt::AtomObject* obj = reinterpret_cast<prt::AtomObject*>(buf);
    obj->atom.type = urids.atom_Object;
    obj->id = 0;
    obj->otype = otype;
    uint32_t off = sizeof(prt::AtomObject);
    if (with_state) {
      auto prop = [&](uint32_t key, uint32_t vtype, const void* v) {
        prt::AtomPropertyBody pb{key, 0, {4, vtype}};
        memcpy(buf + off, &pb, sizeof pb);
        memcpy(buf + off + sizeof pb, v, 4);
        off = prt::atom_pad(off + sizeof pb + 4);
      };
      prop(urids.s_uiscale, urids.atom_Float, &uiscale);
      int32_t l = link ? 1 : 0;
      prop(urids.s_link, urids.atom_Bool, &l);
    }
    obj->atom.size = off - sizeof(prt::Atom);
    write(controller, 0, off, urids.atom_eventTransfer, buf);
  }

  void write_angle(uint32_t chn) {
    if (!write) return;
    float v = dial[chn].value;
    write(controller, 3 + 3 * chn, sizeof v, 0, &v);
  }

  // dial changed by the user: mirror through LINK, write the port(s) —
  // gui/phaserotate.c:838-874 (cb_spn_ctrl + btn_link)
  void dial_changed(uint32_t chn) {
    write_angle(chn);
    if (link && chn == 0 && channels > 1) {
      dial[1].sensitive = true;
      dial[1].set_value(dial[0].value);
      dial[1].sensitive = false;
      write_angle(1);
    }
    dirty = true;
  }

  void set_link(bool active) {
    link = active;
    if (channels > 1) {
      if (active) {  // immediate sync then freeze
        dial[1].sensitive = true;
        dial[1].set_value(dial[0].value);
        dial[1].sensitive = false;
        write_angle(1);
      } else {
        dial[1].sensitive = true;
      }
    }
    send_object(urids.state, true);  // persist (gui/phaserotate.c:1129)
    dirty = true;
  }

  // -- atoms in ----------------------------------------------------------

  void on_notify_object(const prt::AtomObjectView& o) {
    if (o.otype == urids.levels) {
      int32_t chn = 0;
      o.get_i32(urids.l_channel, &chn);
      if (chn < 0 || chn >= static_cast<int32_t>(channels)) return;
      Meter& m = meter[chn];
      o.get_f32(urids.l_in_cur, &m.in_cur);
      o.get_f32(urids.l_in_mom, &m.in_mom);
      o.get_f32(urids.l_in_peak, &m.in_peak);
      o.get_f32(urids.l_out_cur, &m.out_cur);
      o.get_f32(urids.l_out_mom, &m.out_mom);
      o.get_f32(urids.l_out_peak, &m.out_peak);
      o.get_f32(urids.l_diff_cur, &m.diff_cur);
      o.get_f32(urids.l_diff_min, &m.diff_min);
      o.get_f32(urids.l_diff_max, &m.diff_max);
      dirty = true;
    } else if (o.otype == urids.state) {
      float sc = uiscale;
      o.get_f32(urids.s_uiscale, &sc);
      uiscale = sc < 1.0f ? 1.0f : (sc > 2.0f ? 2.0f : sc);
      int32_t l = link ? 1 : 0;
      o.get_i32(urids.s_link, &l);
      bool want = l != 0;
      if (want != link) {
        link = want;  // display only: no echo loop back to the DSP
        if (channels > 1) dial[1].sensitive = !want;
        dirty = true;
      }
    }
  }

  // -- drawing -----------------------------------------------------------

  void fill(int x, int y, int w, int h, uint32_t c) {
    if (x < 0) { w += x; x = 0; }
    if (y < 0) { h += y; y = 0; }
    if (x + w > width) w = width - x;
    if (y + h > height) h = height - y;
    for (int j = 0; j < h; ++j) {
      uint32_t* row = fb + (y + j) * width + x;
      for (int i = 0; i < w; ++i) row[i] = c;
    }
  }

  void put(int x, int y, uint32_t c) {
    if (x >= 0 && y >= 0 && x < width && y < height)
      fb[y * width + x] = c;
  }

  void draw_text(int x, int y, const char* s, int scale, uint32_t c) {
    for (; *s; ++s) {
      for (const Glyph& g : kFont) {
        if (g.ch != *s) continue;
        for (int r = 0; r < 5; ++r)
          for (int b = 0; b < 3; ++b)
            if (g.rows[r] & (4 >> b))
              fill(x + b * scale, y + r * scale, scale, scale, c);
        break;
      }
      x += 4 * scale;
    }
  }

  void draw_level_bar(int x, int y, float cur, float mom, float peak) {
    fill(x, y, kMeterW, kMeterH, kBarBg);
    int lit = static_cast<int>(deflect_meter(kMeterW, cur));
    for (int i = 0; i < lit; ++i) {
      uint32_t c = gradient_color((i + 0.5) / kMeterW);
      for (int j = 1; j < kMeterH - 1; ++j) put(x + i, y + j, c);
    }
    // dB ticks (METER_TICKS_DB of gui/deflect.py)
    static const int ticks[] = {-72, -60, -48, -36, -24, -18,
                                -12, -6, -3, 0, 3, 6};
    for (int t : ticks) {
      int i = static_cast<int>(kMeterW * (t + 80.0) / 86.0);
      if (i >= kMeterW) i = kMeterW - 1;  // +6 dB lands on the edge
      put(x + i, y, kTick);
      put(x + i, y + kMeterH - 1, kTick);
    }
    int mi = static_cast<int>(deflect_meter(kMeterW, mom));
    if (mi > 0)  // momentary cap (gui/phaserotate.c:575-590 role)
      for (int j = 1; j < kMeterH - 1; ++j)
        put(x + (mi >= kMeterW ? kMeterW - 1 : mi), y + j, kCap);
    int pi = static_cast<int>(deflect_meter(kMeterW, peak));
    if (pi > 0)  // peak hold
      for (int j = 0; j < kMeterH; ++j)
        put(x + (pi >= kMeterW ? kMeterW - 1 : pi), y + j, kHold);
  }

  void draw_delta_bar(int x, int y, float cur, float dmin, float dmax) {
    // bidirectional bar around the 0 dB center
    // (gui/phaserotate.c:617-727)
    fill(x, y, kMeterW, kMeterH, kBarBg);
    int center = kMeterW / 2;
    int ci = static_cast<int>(deflect_delta(kMeterW, cur));
    int lo = ci < center ? ci : center, hi = ci < center ? center : ci;
    for (int i = lo; i < hi; ++i)
      for (int j = 1; j < kMeterH - 1; ++j) put(x + i, y + j, kDelta);
    static const int ticks[] = {-12, -9, -6, -3, 0, 3, 6, 9, 12};
    for (int t : ticks) {
      int i = static_cast<int>(kMeterW * (t + 12.0) / 24.0);
      if (i >= kMeterW) i = kMeterW - 1;
      put(x + i, y, kTick);
      put(x + i, y + kMeterH - 1, kTick);
    }
    // min/max excursion markers
    for (float v : {dmin, dmax}) {
      int i = static_cast<int>(deflect_delta(kMeterW, v));
      if (i >= kMeterW) i = kMeterW - 1;
      for (int j = 0; j < kMeterH; ++j) put(x + i, y + j, kHold);
    }
  }

  void draw_dial(int chn, int y0) {
    int cx = kDialCx, cy = y0 + kDialCy;
    // face + ring
    for (int dy = -kDialR; dy <= kDialR; ++dy)
      for (int dx = -kDialR; dx <= kDialR; ++dx) {
        int d2 = dx * dx + dy * dy;
        if (d2 <= kDialR * kDialR) {
          uint32_t c = d2 >= (kDialR - 2) * (kDialR - 2) ? kRing
                                                          : kPanel;
          put(cx + dx, cy + dy, c);
        }
      }
    // tick dots at 45-degree marks (the faceplate art, C22)
    for (int a = 0; a < 360; a += 45) {
      double rad = (a - 90) * M_PI / 180.0;
      int tx = cx + static_cast<int>((kDialR + 4) * cos(rad));
      int ty = cy + static_cast<int>((kDialR + 4) * sin(rad));
      fill(tx - 1, ty - 1, 2, 2, a == 0 ? kText : kTick);
    }
    // pointer: value degrees, 0 at top, clockwise positive
    double rad = (dial[chn].value - 90.0) * M_PI / 180.0;
    uint32_t pc = dial[chn].sensitive ? kPointer : kTick;
    for (int r = 6; r < kDialR - 4; ++r) {
      int px = cx + static_cast<int>(r * cos(rad));
      int py = cy + static_cast<int>(r * sin(rad));
      fill(px, py, 2, 2, pc);
    }
    // numeric readout
    char txt[16];
    snprintf(txt, sizeof txt, "%.1f", dial[chn].value);
    draw_text(cx - 4 * 2 * static_cast<int>(strlen(txt)) / 2,
              y0 + kReadoutY, txt, 2, kText);
  }

  void render() {
    fill(0, 0, width, height, kBg);
    for (uint32_t c = 0; c < channels; ++c) {
      int y0 = c * kRowH;
      draw_dial(c, y0);
      const Meter& m = meter[c];
      draw_level_bar(kMeterX, y0 + kMeterYIn, m.in_cur, m.in_mom,
                     m.in_peak);
      draw_level_bar(kMeterX, y0 + kMeterYOut, m.out_cur, m.out_mom,
                     m.out_peak);
      draw_delta_bar(kMeterX, y0 + kMeterYDelta, m.diff_cur, m.diff_min,
                     m.diff_max);
    }
    if (channels > 1) {  // LINK checkbox row
      int y = channels * kRowH + 5;
      fill(kDialCx - 8, y, 16, 16, link ? kLinkOn : kLinkOff);
      fill(kDialCx - 8, y, 16, 1, kTick);
      fill(kDialCx - 8, y + 15, 16, 1, kTick);
      fill(kDialCx - 8, y, 1, 16, kTick);
      fill(kDialCx + 7, y, 1, 16, kTick);
    }
    dirty = false;
  }

  // -- input (shared by X events and test injection) ---------------------

  int hit_dial(int x, int y) const {
    for (uint32_t c = 0; c < channels; ++c) {
      int dx = x - kDialCx, dy = y - (c * kRowH + kDialCy);
      if (dx * dx + dy * dy <= kDialR * kDialR)
        return static_cast<int>(c);
    }
    return -1;
  }

  int hit_meter(int x, int y) const {
    if (x < kMeterX || x >= kMeterX + kMeterW) return -1;
    for (uint32_t c = 0; c < channels; ++c) {
      int ry = y - c * kRowH;
      if ((ry >= kMeterYIn && ry < kMeterYIn + kMeterH) ||
          (ry >= kMeterYOut && ry < kMeterYOut + kMeterH) ||
          (ry >= kMeterYDelta && ry < kMeterYDelta + kMeterH))
        return static_cast<int>(c);
    }
    return -1;
  }

  bool hit_link(int x, int y) const {
    if (channels < 2) return false;
    int ly = channels * kRowH + 5;
    return x >= kDialCx - 8 && x < kDialCx + 8 && y >= ly && y < ly + 16;
  }

  void pointer_press(int x, int y, int button) {
    if (button == 4 || button == 5) {  // wheel: scroll x10
      int c = hit_dial(x, y);
      if (c >= 0 && dial[c].scroll(button == 4 ? 1 : -1))
        dial_changed(c);
      return;
    }
    int c = hit_dial(x, y);
    if (c >= 0 && dial[c].sensitive) {
      drag_chn = c;
      drag_y0 = y;
      drag_v0 = dial[c].value;
      return;
    }
    if (hit_meter(x, y) >= 0) {  // click-on-meter: reset peaks
      send_object(urids.reset_peaks, false);
      return;
    }
    if (hit_link(x, y)) set_link(!link);
  }

  void pointer_motion(int, int y) {
    if (drag_chn < 0) return;
    // vertical drag, one 0.5-degree step per pixel (fine control; a
    // full top-to-bottom sweep covers ~the +-45 degree working range)
    float v = drag_v0 + (drag_y0 - y) * Dial::kStep;
    if (dial[drag_chn].set_value(v)) dial_changed(drag_chn);
  }

  void pointer_release(int, int, int) { drag_chn = -1; }

  // -- X11 ---------------------------------------------------------------

  bool x_open(unsigned long parent) {
    if (getenv("PHASEROTATE_TPU_XUI") &&
        strcmp(getenv("PHASEROTATE_TPU_XUI"), "headless") == 0)
      return false;
    x11::Api& X = x11::api();
    if (!X.load()) return false;
    if (X.XInitThreads) X.XInitThreads();
    dpy = X.XOpenDisplay(nullptr);
    if (!dpy) return false;
    int scr = X.XDefaultScreen(dpy);
    x11::Window root =
        parent ? static_cast<x11::Window>(parent)
               : X.XDefaultRootWindow(dpy);
    win = X.XCreateSimpleWindow(dpy, root, 0, 0, width, height, 0, 0,
                                0xff101010);
    if (!win) {
      X.XCloseDisplay(dpy);
      dpy = nullptr;
      return false;
    }
    X.XSelectInput(dpy, win,
                   x11::kExposureMask | x11::kButtonPressMask |
                       x11::kButtonReleaseMask | x11::kPointerMotionMask |
                       x11::kButtonMotionMask |
                       x11::kStructureNotifyMask);
    X.XStoreName(dpy, win, "Phase Rotate (GPU)");
    gc = X.XCreateGC(dpy, win, 0, nullptr);
    img = X.XCreateImage(dpy, X.XDefaultVisual(dpy, scr),
                         X.XDefaultDepth(dpy, scr), 2 /*ZPixmap*/, 0,
                         reinterpret_cast<char*>(fb), width, height, 32,
                         width * 4);
    if (parent) {
      X.XMapWindow(dpy, win);
      mapped = true;
    }
    headless = false;
    return true;
  }

  void x_blit() {
    if (headless || !mapped) return;
    x11::Api& X = x11::api();
    X.XPutImage(dpy, win, gc, img, 0, 0, 0, 0, width, height);
    X.XFlush(dpy);
  }

  void x_pump() {
    if (headless) return;
    x11::Api& X = x11::api();
    while (X.XPending(dpy) > 0) {
      x11::XEventPad ev{};
      X.XNextEvent(dpy, &ev);
      const auto* e = reinterpret_cast<x11::XAnyishEvent*>(&ev);
      switch (e->type) {
        case x11::kButtonPress:
          pointer_press(e->x, e->y, e->button);
          break;
        case x11::kButtonRelease:
          pointer_release(e->x, e->y, e->button);
          break;
        case x11::kMotionNotify:
          pointer_motion(e->x, e->y);
          break;
        case x11::kExpose:
          dirty = true;
          break;
        default:
          break;
      }
    }
  }

  void x_close() {
    if (headless) return;
    x11::Api& X = x11::api();
    if (img) {
      // XDestroyImage would free our framebuffer; drop the struct only
      free(img);
      img = nullptr;
    }
    if (gc) X.XFreeGC(dpy, gc);
    if (win) X.XDestroyWindow(dpy, win);
    if (dpy) X.XCloseDisplay(dpy);
    dpy = nullptr;
    win = 0;
    headless = true;
  }

  int idle() {
    x_pump();
    if (dirty) {
      render();
      x_blit();
    }
    return 0;
  }
};

LV2UI_Handle instantiate(const LV2UI_Descriptor*, const char* plugin_uri,
                         const char*, LV2UI_Write_Function write_function,
                         LV2UI_Controller controller, LV2UI_Widget* widget,
                         const LV2_Feature_* const* features) {
  Ui* ui = new (std::nothrow) Ui();
  if (!ui) return nullptr;
  ui->channels = strcmp(plugin_uri, kUriStereo) == 0 ? 2 : 1;
  ui->write = write_function;
  ui->controller = controller;
  ui->height = ui->channels * kRowH +
               (ui->channels > 1 ? kLinkRowH : 0);
  ui->fb = static_cast<uint32_t*>(
      calloc(ui->width * ui->height, sizeof(uint32_t)));
  if (!ui->fb) {
    delete ui;
    return nullptr;
  }
  unsigned long parent = 0;
  const LV2UI_Resize* resize = nullptr;
  for (const LV2_Feature_* const* f = features; f && *f; ++f) {
    if (strcmp((*f)->URI, prt::kUridMapUri) == 0)
      ui->urids.map_all(static_cast<const prt::UridMap*>((*f)->data));
    else if (strcmp((*f)->URI,
                    "http://lv2plug.in/ns/extensions/ui#parent") == 0)
      parent = reinterpret_cast<uintptr_t>((*f)->data);
    else if (strcmp((*f)->URI,
                    "http://lv2plug.in/ns/extensions/ui#resize") == 0)
      resize = static_cast<const LV2UI_Resize*>((*f)->data);
  }
  if (resize && resize->ui_resize)  // report our fixed surface size
    resize->ui_resize(resize->handle, ui->width, ui->height);
  ui->x_open(parent);
  ui->render();
  if (widget) *widget = reinterpret_cast<LV2UI_Widget>(ui->win);
  ui->send_object(ui->urids.ui_on, false);  // gui/phaserotate.c:1099
  return ui;
}

void cleanup(LV2UI_Handle h) {
  Ui* ui = static_cast<Ui*>(h);
  ui->send_object(ui->urids.ui_off, false);  // gui/phaserotate.c:1113
  ui->x_close();
  free(ui->fb);
  delete ui;
}

void port_event(LV2UI_Handle h, uint32_t port, uint32_t size,
                uint32_t format, const void* buffer) {
  Ui* ui = static_cast<Ui*>(h);
  if (format == 0 && size == sizeof(float) && port >= 3 &&
      (port - 3) % 3 == 0) {
    // host echo of an angle control port -> dial display follows
    // (gui/phaserotate.c:1236-1250 role), without writing back
    uint32_t chn = (port - 3) / 3;
    if (chn < ui->channels) {
      float v;
      memcpy(&v, buffer, 4);
      Dial& d = ui->dial[chn];
      bool was = d.sensitive;
      d.sensitive = true;
      if (d.set_value(v)) ui->dirty = true;
      d.sensitive = was;
    }
    return;
  }
  if (ui->urids.ok && format == ui->urids.atom_eventTransfer &&
      port == 1 && size >= sizeof(prt::Atom)) {
    const prt::Atom* a = static_cast<const prt::Atom*>(buffer);
    if (a->type == ui->urids.atom_Sequence) {
      prt::each_object(
          buffer, ui->urids,
          [&](const prt::AtomObjectView& o) { ui->on_notify_object(o); },
          size);  // cap reads at the delivered buffer, not atom.size
    } else if (a->type == ui->urids.atom_Object &&
               a->size >= 8 && a->size <= size - sizeof(prt::Atom)) {
      const prt::AtomObject* obj =
          static_cast<const prt::AtomObject*>(buffer);
      prt::AtomObjectView view;
      view.otype = obj->otype;
      view.props = static_cast<const uint8_t*>(buffer) +
                   sizeof(prt::AtomObject);
      view.props_size = a->size - 8;
      ui->on_notify_object(view);
    }
  }
}

int ui_idle(LV2UI_Handle h) { return static_cast<Ui*>(h)->idle(); }

int ui_show(LV2UI_Handle h) {
  Ui* ui = static_cast<Ui*>(h);
  if (!ui->headless && !ui->mapped) {
    x11::api().XMapWindow(ui->dpy, ui->win);
    x11::api().XFlush(ui->dpy);
    ui->mapped = true;
  }
  return 0;
}

int ui_hide(LV2UI_Handle h) {
  Ui* ui = static_cast<Ui*>(h);
  if (!ui->headless && ui->mapped) {
    x11::api().XUnmapWindow(ui->dpy, ui->win);
    x11::api().XFlush(ui->dpy);
    ui->mapped = false;
  }
  return 0;
}

const LV2UI_Idle_Interface kIdle = {ui_idle};
const LV2UI_Show_Interface kShow = {ui_show, ui_hide};

const void* extension_data(const char* uri) {
  if (strcmp(uri, "http://lv2plug.in/ns/extensions/ui#idleInterface") ==
      0)
    return &kIdle;
  if (strcmp(uri, "http://lv2plug.in/ns/extensions/ui#showInterface") ==
      0)
    return &kShow;
  return nullptr;
}

const LV2UI_Descriptor kDescriptor = {
    kUiUri, instantiate, cleanup, port_event, extension_data,
};

}  // namespace

extern "C" {

__attribute__((visibility("default")))
const LV2UI_Descriptor* lv2ui_descriptor(uint32_t index) {
  return index == 0 ? &kDescriptor : nullptr;
}

// -- test hooks: drive the identical framebuffer + input pipeline
// -- without a display (tests/test_xui.py)

__attribute__((visibility("default")))
uint32_t* prt_xui_test_framebuffer(LV2UI_Handle h, int* w, int* ht) {
  Ui* ui = static_cast<Ui*>(h);
  if (w) *w = ui->width;
  if (ht) *ht = ui->height;
  return ui->fb;
}

// kind: 0 press, 1 release, 2 motion, 3 wheel (data: +1 up / -1 down)
__attribute__((visibility("default")))
void prt_xui_test_pointer(LV2UI_Handle h, int kind, int x, int y,
                          int data) {
  Ui* ui = static_cast<Ui*>(h);
  switch (kind) {
    case 0: ui->pointer_press(x, y, data ? data : 1); break;
    case 1: ui->pointer_release(x, y, data ? data : 1); break;
    case 2: ui->pointer_motion(x, y); break;
    case 3: ui->pointer_press(x, y, data > 0 ? 4 : 5); break;
  }
}

__attribute__((visibility("default")))
int prt_xui_test_headless(LV2UI_Handle h) {
  return static_cast<Ui*>(h)->headless ? 1 : 0;
}

__attribute__((visibility("default")))
float prt_xui_test_dial(LV2UI_Handle h, int chn) {
  Ui* ui = static_cast<Ui*>(h);
  return chn >= 0 && chn < static_cast<int>(ui->channels)
             ? ui->dial[chn].value
             : 0.0f;
}

}  // extern "C"
